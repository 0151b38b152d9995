"""Acceleration-structure backend protocol.

The reference's plugin API is the ``IntrsHandler`` trait: a handler
returns GPU buffers plus a WGSL ``intrs()`` source string that gets
string-spliced into the compute shader
(``src/lib/handlers/mod.rs:52-67``, ``src/lib/shaders/mod.rs:31-83``).

The JAX equivalent of "shader codegen" is closure capture +
``jax.jit`` specialization: a handler builds device arrays (the
"bind group"), may permute the scene's primitive arrays (the leaf
reordering of ``handlers/bvh.rs:103-110``), and returns a jittable
closest-hit function.  Static metadata (node count, stack depth) bakes
into the compiled program exactly like the reference bakes its stack
size into the shader source (``handlers/bvh.rs:168-187``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.ops.shade import IntersectFn
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


@dataclasses.dataclass(frozen=True)
class IntrsStats:
    """Handler name + acceleration-structure byte footprint
    (``src/lib/handlers/mod.rs:47-50``) — the source of the study's
    memory table."""

    name: str
    size: int


class IntrsHandler(abc.ABC):
    """One acceleration backend (blank / naive / bvh / rf_bvh / lbvh)."""

    name: str = "?"

    @abc.abstractmethod
    def build(
        self, scene: Scene, arrays: SceneArrays
    ) -> tuple[Any, SceneArrays]:
        """Build device-side structures.

        Returns ``(accel, arrays)`` where ``accel`` is an arbitrary
        pytree (or ``None``) and ``arrays`` is the — possibly
        leaf-reordered — scene to use for shading.
        """

    @abc.abstractmethod
    def stats(self, accel: Any) -> IntrsStats:
        ...

    @abc.abstractmethod
    def intersect_fn(
        self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig
    ) -> IntersectFn:
        """Return the jittable closest-hit:
        ``(o, d, excl, valid, *, t_cap=None) -> (t, id)`` (see
        ``rt_rs_tpu.ops.shade.IntersectFn`` for the contract)."""

    def intersect_tiled_fn(
        self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig
    ):
        """Closest-hit over component-major ray tiles:
        ``(payload [8,T,r], valid [T,r], t_cap=None) -> (t [T,r],
        pid [T,r])`` — the zero-relayout contract of
        :func:`rt_rs_tpu.ops.shade.trace_tiled` (payload row 6 is the
        f32 exclusion id).

        Packet-kernel backends override this with the native tiled
        entry; this default adapts any AoS ``intersect_fn`` (one
        [T,r,3] relayout per call — fine for the slow/portable
        backends)."""
        import jax.numpy as jnp

        aos = self.intersect_fn(accel, arrays, cfg)

        def tiled(payload, valid, t_cap=None):
            t_tiles, r = valid.shape
            o = payload[0:3].transpose(1, 2, 0).reshape(-1, 3)
            d = payload[3:6].transpose(1, 2, 0).reshape(-1, 3)
            excl = payload[6].reshape(-1).astype(jnp.int32)
            cap = None if t_cap is None else t_cap.reshape(-1)
            t, pid = aos(o, d, excl, valid.reshape(-1), t_cap=cap)
            return t.reshape(t_tiles, r), pid.reshape(t_tiles, r)

        return tiled

    def intersect_tiled_anyhit_fn(
        self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig
    ):
        """Occlusion-only variant: ``(payload, valid, t_cap=None) ->
        blocked [T, r] bool`` where a ray is blocked iff some primitive
        (other than its exclusion) lies within ``(t_min, payload row
        7)``.  ``None`` (default) = unsupported; shadow batches then
        use the closest-hit path (identical results)."""
        return None

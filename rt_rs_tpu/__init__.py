"""rt_rs_tpu — a wavefront ray tracing framework in JAX.

A from-scratch rebuild of the capabilities of the reference renderer
``hankotanks/rt_rs`` (Rust + WGSL compute shaders), running on an
NVIDIA GPU through XLA and Pallas:

* rays are a batch axis (wavefront), not SIMT threads
  (reference: one shader invocation per pixel,
  ``src/lib/state/mod.rs:704-708``);
* the BVH is a set of flat device-resident arrays, not pointer-linked
  nodes (reference: ``src/lib/bvh/mod.rs:11-27``);
* traversal runs as a Pallas *packet* kernel — per-tile conservative
  chunk culling (interval + per-ray slab refinement) with argsort
  compaction outside the kernel, Möller–Trumbore lattices over
  (triangles, rays) blocks inside it, compiled through Triton (reference: per-thread private
  stack DFS, ``src/lib/handlers/bvh.rs:303-350``);
* shading, shadow rays and the bounce loop are pure jitted JAX
  (reference: ``src/lib/shaders/compute.wgsl:219-293``);
* multi-device scaling shards the image across a ``jax.sharding.Mesh``
  (the reference is single-GPU).

Scene JSON, OBJ meshes and precomputed ``*.bvh.json`` checkpoints are
byte-compatible with the reference formats.
"""

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.camera import CameraUniform, CameraController
from rt_rs_tpu.renderer import DynamicRenderer, Renderer, run_headless

__version__ = "0.1.0"

__all__ = [
    "ComputeConfig",
    "Config",
    "Resolution",
    "Scene",
    "CameraUniform",
    "CameraController",
    "Renderer",
    "DynamicRenderer",
    "run_headless",
]

"""Seeded scenes built in code: the benchmark and test scenes.

Every scene here is a pure function of its ``seed``, so a machine that
holds nothing but this repository can render the same frames.

* :func:`base_scene` — the study's scale: 6,320 triangles (the prim
  count of the reference's ``teatime.json``), two point lights, an
  orbiting camera.  Three closed tori with seeded radial noise and
  smooth (area-weighted) vertex normals stand on a ground quad.  Every
  material has a reflective ``albedo.z`` so bounces 2-4 do real work;
  no material is negative, so frames take the tiled path.
* :func:`large_scene` — :func:`base_scene` tiled 8 times
  (``presets.tiled_copies``): 50,560 triangles in a 4 x 2 "canyon".
* :func:`small_scene` — one coarse torus on the ground quad (50
  triangles): small enough for the scalar test oracle.
"""

from __future__ import annotations

import os

import numpy as np

from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.camera import CameraController, CameraUniform

# (major radius, minor radius, segments around, segments across) of the
# three tori: 2 * (48*32 + 40*24 + 39*17) + 2 ground triangles = 6,320.
TORI = ((2.2, 0.8, 48, 32), (1.6, 0.55, 40, 24), (1.2, 0.45, 39, 17))
SMALL_TORI = ((2.2, 0.8, 6, 4),)
BASE_TRIS = 6320
LARGE_COPIES = 8
LARGE_SPACING = 18.0  # = the ground quad's width: quads meet, never overlap


def _torus(rng, major, minor, nu, nv):
    """A closed torus grid with seeded radial displacement -> (positions
    [nu*nv, 3], triangles [2*nu*nv, 3]) in the torus' own frame."""
    u = np.arange(nu) * (2.0 * np.pi / nu)
    v = np.arange(nv) * (2.0 * np.pi / nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # [nu, nv]
    # Periodic noise: a few low-frequency sinusoids with seeded phases.
    bump = np.zeros_like(uu)
    for fu, fv in ((2, 1), (3, 2), (5, 3)):
        amp = rng.uniform(0.04, 0.12)
        pu, pv = rng.uniform(0.0, 2.0 * np.pi, 2)
        bump += amp * np.sin(fu * uu + pu) * np.cos(fv * vv + pv)
    rad = minor * (1.0 + bump)
    ring = major + rad * np.cos(vv)
    pos = np.stack(
        [ring * np.cos(uu), rad * np.sin(vv), ring * np.sin(uu)], axis=-1
    ).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    tris = np.concatenate(
        [np.stack([a, d, c], -1).reshape(-1, 3),
         np.stack([a, c, b], -1).reshape(-1, 3)]
    )
    return pos, tris


def _smooth_normals(pos, tris):
    """Area-weighted vertex normals of a closed mesh (all finite)."""
    fa, fb, fc = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(fb - fa, fc - fa)  # length = 2 * area
    acc = np.zeros_like(pos)
    for k in range(3):
        np.add.at(acc, tris[:, k], fn)
    return acc / np.linalg.norm(acc, axis=1, keepdims=True)


def base_scene(seed: int = 0) -> Scene:
    """The study-scale scene (6,320 triangles, 2 lights) for ``seed``."""
    return _torus_scene(seed, TORI)


def small_scene(seed: int = 0) -> Scene:
    """One 48-triangle torus on the ground quad (50 triangles)."""
    return _torus_scene(seed, SMALL_TORI)


def _torus_scene(seed: int, tori) -> Scene:
    rng = np.random.default_rng(seed)
    scene = Scene.empty(
        camera=CameraUniform((0.0, 5.0, -13.0), (0.0, 0.8, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    # Ground quad (material 0), facing up.
    g = 9.0
    vp = [np.array([[-g, 0, -g], [g, 0, -g], [g, 0, g], [-g, 0, g]], float)]
    vn = [np.tile([[0.0, 1.0, 0.0]], (4, 1))]
    prims = [np.array([[0, 2, 1], [0, 3, 2]])]
    mats = [np.zeros(2, np.int32)]
    base = 4
    angles = rng.uniform(0.0, 2.0 * np.pi, len(tori))
    for m, (major, minor, nu, nv) in enumerate(tori):
        pos, tris = _torus(rng, major, minor, nu, nv)
        # Tilt about x, spin about y, place on a ring around the origin.
        tilt = rng.uniform(0.3, 1.2)
        ct, st = np.cos(tilt), np.sin(tilt)
        pos = pos @ np.array([[1, 0, 0], [0, ct, st], [0, -st, ct]])
        spin = rng.uniform(0.0, 2.0 * np.pi)
        cs, ss = np.cos(spin), np.sin(spin)
        pos = pos @ np.array([[cs, 0, -ss], [0, 1, 0], [ss, 0, cs]])
        r_place = 3.4 if m else 0.0
        pos = pos + np.array(
            [r_place * np.cos(angles[m]),
             major + minor + 0.3,
             r_place * np.sin(angles[m])]
        )
        vp.append(pos)
        vn.append(_smooth_normals(pos, tris))
        prims.append(tris + base)
        mats.append(np.full(len(tris), m + 1, np.int32))
        base += len(pos)
    scene.vert_pos = np.concatenate(vp).astype(np.float32)
    scene.vert_norm = np.concatenate(vn).astype(np.float32)
    scene.prim_indices = np.concatenate(prims).astype(np.uint32)
    scene.prim_material = np.concatenate(mats)
    scene.light_pos = np.array(
        [[8.0, 14.0, -9.0], [-10.0, 9.0, 6.0]], np.float32
    )
    scene.light_strength = np.array([1.2, 0.8], np.float32)
    # Colors, diffuse/specular albedo and reflectance (albedo.z) in the
    # ranges of presets.mesh_scene's material; reflective throughout.
    n_mat = len(tori) + 1
    scene.mat_color = rng.uniform(0.1, 0.9, (n_mat, 3)).astype(np.float32)
    scene.mat_albedo = np.stack(
        [
            rng.uniform(0.6, 0.95, n_mat),
            rng.uniform(0.05, 0.3, n_mat),
            rng.uniform(0.25, 0.6, n_mat),
        ],
        axis=1,
    ).astype(np.float32)
    scene.mat_spec = rng.uniform(8.0, 40.0, n_mat).astype(np.float32)
    return scene


def large_scene(seed: int = 0) -> Scene:
    """:func:`base_scene` tiled 8 times on a 4 x 2 grid (50,560
    triangles), camera pulled back to frame the whole canyon."""
    from rt_rs_tpu.scene.presets import tiled_copies

    base = base_scene(seed)
    s = LARGE_SPACING
    offsets = [
        ((i - 1.5) * s, 0.0, (j - 0.5) * s)
        for j in range(2)
        for i in range(4)
    ]
    big = tiled_copies(base, offsets)
    big.camera = CameraUniform((0.0, 22.0, -50.0), (0.0, 1.0, 0.0))
    big.light_pos = np.array(
        [[20.0, 30.0, -20.0], [-24.0, 22.0, 14.0]], np.float32
    )
    return big


def base_scene_path(seed: int = 0) -> str:
    """:func:`base_scene` written as scene JSON inside the checkout
    (``scenes/base_seed<seed>.json``, made on first use) — the default
    ``--path`` of the command-line tools and the web viewer."""
    from rt_rs_tpu.utils.cache import CHECKOUT

    path = os.path.join(CHECKOUT, "scenes", f"base_seed{seed}.json")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        base_scene(seed).save(tmp, pretty=False)
        os.replace(tmp, path)
    return path

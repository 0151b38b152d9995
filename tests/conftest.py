"""Test configuration: the CPU with 8 virtual devices by default.

Pallas kernels run in the interpreter there (``kernel_mode()``), and
multi-device sharding tests use the virtual CPU mesh
(``xla_force_host_platform_device_count``).  ``RT_RS_TESTS_ON_GPU=1``
keeps JAX's default platform instead, so the ``gpu``-marked tests can
run on a card: ``RT_RS_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``.

Tests that pin facts of the reference project's own files (its scene
JSONs, OBJ meshes, precomputed BVHs and goldens rendered from them)
carry the ``reference`` marker and read them from the directory named
by ``RT_RS_REFERENCE``; without it they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("RT_RS_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402


def _reference_dir() -> pathlib.Path:
    root = os.environ.get("RT_RS_REFERENCE")
    if not root or not pathlib.Path(root).is_dir():
        pytest.skip(
            "needs the reference project's files: set RT_RS_REFERENCE "
            "to a checkout of it"
        )
    return pathlib.Path(root)


@pytest.fixture(autouse=True)
def _no_checkout_compile_cache(monkeypatch, tmp_path_factory):
    """Entry points called in-process (``load.main``) find a compile
    cache directory in the environment and so leave JAX's config and
    the checkout alone."""
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.getbasetemp() / "jc")
    )


@pytest.fixture(scope="session")
def scenes_dir() -> pathlib.Path:
    """The reference's ``scenes/`` (``reference`` tests only)."""
    return _reference_dir() / "scenes"


@pytest.fixture(scope="session")
def meshes_dir() -> pathlib.Path:
    """The reference's ``meshes/`` (``reference`` tests only)."""
    return _reference_dir() / "meshes"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (``gpu`` tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with RT_RS_TESTS_ON_GPU=1)")


@pytest.fixture(scope="session")
def base_scene():
    """The generated study-scale scene (seed 0, 6,320 triangles)."""
    from rt_rs_tpu.scene.procedural import base_scene

    return base_scene(0)


@pytest.fixture(scope="session")
def small_scene():
    """The generated 50-triangle scene (seed 0) for the scalar oracle."""
    from rt_rs_tpu.scene.procedural import small_scene

    return small_scene(0)

"""Test harness: the CPU with 8 virtual devices unless JAX_PLATFORMS
says otherwise, so sharding tests run without accelerators (mirrors the
reference's llvm_ad_mono CPU variant role, test_integrators.py:69).
Tests marked `gpu` need a card and skip elsewhere; run them with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from drtvam_tpu.utils.jax_cache import enable_compile_cache

# persistent compile cache: the march/backproject kernels dominate test
# wall-clock; repeat runs skip their XLA compiles entirely
enable_compile_cache()

import pytest


@pytest.fixture(scope="session")
def box_hole_mesh(tmp_path_factory):
    """Procedural stand-in for the reference's tests/files/box_hole.ply:
    a box with a cylindrical through-hole."""
    from drtvam_tpu.ops.mesh import make_box_with_hole, save_ply
    path = tmp_path_factory.mktemp("meshes") / "box_hole.ply"
    mesh = make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=99)
    save_ply(mesh, str(path))
    return str(path)

"""Native XY-grid voxelizer (native/mesh_accel.cpp) must reproduce the
JAX column-parity voxelizer (ops/voxelize.py) on the box-with-hole
fixture, and handle a large (many-10k-triangle) bank fast."""
import os
import time

import numpy as np
import pytest

from drtvam_tpu.ops.mesh import make_box_with_hole, load_mesh, save_ply
from drtvam_tpu.ops import voxelize
from drtvam_tpu.native import mesh_accel_available, voxelize_mesh_native


def _bank(mesh):
    return mesh.triangle_bank()


@pytest.fixture(scope="module")
def box_hole_bank():
    mesh = make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=33)
    return _bank(mesh)


@pytest.mark.skipif(not mesh_accel_available(),
                    reason="native mesh_accel unavailable")
def test_occupancy_matches_jax(box_hole_bank):
    bmin = np.array([-1.5, -1.5, -0.8], np.float32)
    bmax = np.array([1.5, 1.5, 0.8], np.float32)
    res = (24, 20, 16)
    nat = voxelize_mesh_native(box_hole_bank, bmin, bmax, res, mode=0)
    os.environ["DRTVAM_NATIVE_VOXELIZE"] = "0"
    try:
        ref = np.asarray(voxelize.occupancy(box_hole_bank, bmin, bmax,
                                            res))[..., 0]
    finally:
        os.environ.pop("DRTVAM_NATIVE_VOXELIZE")
    # center-parity is discrete; tolerate a sliver of boundary voxels
    # where f32 column positions round differently
    disagree = np.mean(nat != ref)
    assert disagree < 5e-3, f"occupancy mismatch on {disagree:.2%} voxels"


@pytest.mark.skipif(not mesh_accel_available(),
                    reason="native mesh_accel unavailable")
def test_fractional_matches_jax(box_hole_bank):
    bmin = np.array([-1.5, -1.5, -0.8], np.float32)
    bmax = np.array([1.5, 1.5, 0.8], np.float32)
    res = (16, 16, 12)
    nat = voxelize.fractional_volumes(box_hole_bank, bmin, bmax, res,
                                      oversample=2)
    os.environ["DRTVAM_NATIVE_VOXELIZE"] = "0"
    try:
        ref = np.asarray(voxelize.fractional_volumes(
            box_hole_bank, bmin, bmax, res, oversample=2))
    finally:
        os.environ.pop("DRTVAM_NATIVE_VOXELIZE")
    vox_vol = float(np.prod((bmax - bmin) / np.asarray(res, np.float32)))
    np.testing.assert_allclose(np.asarray(nat), ref,
                               atol=5e-3 * vox_vol)


@pytest.mark.skipif(not mesh_accel_available(),
                    reason="native mesh_accel unavailable")
def test_large_bank_is_fast(box_hole_bank):
    """A ~85k-triangle bank voxelizes to 128^3 in seconds on the host —
    the scale a real Benchy target needs."""
    mesh = make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=10999)
    bank = _bank(mesh)
    n_tris = bank[0].shape[0]
    assert n_tris > 80_000
    bmin = np.array([-1.5, -1.5, -0.8], np.float32)
    bmax = np.array([1.5, 1.5, 0.8], np.float32)
    t0 = time.time()
    occ = voxelize_mesh_native(bank, bmin, bmax, (128, 128, 128), mode=0)
    dt = time.time() - t0
    assert occ is not None and occ.sum() > 0
    assert dt < 30.0, f"native voxelize too slow: {dt:.1f}s"
    # coarse volume sanity: the (half-extent 2, 2, 1) box covers the
    # whole bbox window, so inside = window volume minus the hole
    # cylinder's share of the z window
    vox = np.prod((bmax - bmin) / 128.0)
    vol = occ.sum() * vox
    window = np.prod(bmax - bmin)
    expect = window - np.pi * 0.5 ** 2 * (bmax[2] - bmin[2])
    assert abs(vol - expect) / expect < 0.05

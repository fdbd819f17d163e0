"""Mesh voxelization: binary occupancy + surface-aware fractional volumes.

The reference voxelizes by casting one random-direction ray per voxel
center and testing for a backface hit (utils.py:83-128 `discretize`), and
estimates per-voxel inside/outside fractional volumes with 2^14
point-in-mesh Monte-Carlo samples (sensor.py:47-110 `compute_volume`).

Here both are computed from z-column crossings: for each (x, y) column we
collect all ray/mesh intersections along +z, and parity intervals give
exact inside spans per column. Binary occupancy tests the voxel-center
parity (identical semantics for watertight meshes, deterministic);
fractional volumes integrate the covered z-length exactly and supersample
in xy — a deterministic, branch-free replacement for the reference's MC
estimate with far fewer ray casts.
"""
from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .intersect import ray_triangles

MAX_CROSSINGS = 32


def _native_voxelize(tri_bank, bbox_min, bbox_max, res, mode,
                     oversample=4):
    """Host C++ XY-grid voxelizer (native/mesh_accel.cpp) — the fast
    path for large triangle banks and for keeping scene preprocessing
    off the device. Returns None when the library can't build."""
    if os.environ.get("DRTVAM_NATIVE_VOXELIZE", "1") == "0":
        return None
    from ..native import voxelize_mesh_native
    return voxelize_mesh_native(tri_bank, bbox_min, bbox_max, res, mode,
                                oversample)


def _mesh_z_start(v0, e1, e2, bbox_min):
    """A z strictly below BOTH the film bbox and the whole mesh —
    columns must start under every surface or parity flips are lost
    when the mesh extends below the sensor volume."""
    zmin = jnp.minimum(jnp.min(v0[:, 2]),
                       jnp.minimum(jnp.min(v0[:, 2] + e1[:, 2]),
                                   jnp.min(v0[:, 2] + e2[:, 2])))
    return jnp.minimum(jnp.asarray(bbox_min)[2], zmin) - 1.0


def _column_crossings(v0, e1, e2, xy, z_start, max_k=MAX_CROSSINGS):
    """All intersection z's of +z rays from (x, y, z_start).

    xy: (n, 2). Returns (n, max_k) ascending z values padded with +inf.
    """
    n = xy.shape[0]
    o = jnp.concatenate(
        [xy, jnp.full((n, 1), z_start, xy.dtype)], -1)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), o.shape)

    def body(k, carry):
        tmin, out = carry
        t, _ = ray_triangles(o, d, tmin, v0, e1, e2)
        out = out.at[:, k].set(z_start + t)
        # nudge past the hit; relative epsilon for f32 robustness
        eps = 1e-4 + 1e-5 * jnp.abs(t)
        tmin = jnp.where(jnp.isfinite(t), t + eps, jnp.inf)
        return tmin, out

    tmin0 = jnp.full((n,), 1e-6, jnp.float32)
    out0 = jnp.full((n, max_k), jnp.inf, jnp.float32)
    _, out = jax.lax.fori_loop(0, max_k, body, (tmin0, out0))
    return out


def occupancy(tri_bank, bbox_min, bbox_max, res):
    """Binary occupancy grid (Z, Y, X, 1) from voxel-center parity.

    res = (X, Y, Z); bbox_* world coords of the sensor volume.
    """
    native = _native_voxelize(tri_bank, bbox_min, bbox_max, res, mode=0)
    if native is not None:
        return native[..., None]
    v0, e1, e2, _ = tri_bank
    X, Y, Z = res
    vs = (jnp.asarray(bbox_max) - jnp.asarray(bbox_min)) / \
        jnp.asarray([X, Y, Z], jnp.float32)
    xs = bbox_min[0] + (jnp.arange(X) + 0.5) * vs[0]
    ys = bbox_min[1] + (jnp.arange(Y) + 0.5) * vs[1]
    zs = bbox_min[2] + (jnp.arange(Z) + 0.5) * vs[2]
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")  # (Y, X)
    xy = jnp.stack([gx.ravel(), gy.ravel()], -1)
    z_start = _mesh_z_start(v0, e1, e2, bbox_min)
    cross = _column_crossings(v0, e1, e2, xy, z_start)  # (Y*X, K)
    # parity at each voxel-center z
    below = cross[None, :, :] <= zs[:, None, None]  # (Z, Y*X, K)
    inside = (jnp.sum(below, -1) % 2) == 1
    return inside.reshape(Z, Y, X, 1).astype(jnp.float32)


def fractional_volumes(tri_bank, bbox_min, bbox_max, res, oversample=4):
    """Surface-aware per-voxel (inside, outside) volumes, (Z, Y, X, 2).

    Exact along z via parity intervals; supersampled oversample^2 in xy.
    Matches the reference's convention: channel 0 = inside volume,
    channel 1 = outside volume, summing to the voxel volume
    (sensor.py:105-107).
    """
    native = _native_voxelize(tri_bank, bbox_min, bbox_max, res, mode=1,
                              oversample=oversample)
    if native is not None:
        bmin = np.asarray(bbox_min, np.float32)
        bmax = np.asarray(bbox_max, np.float32)
        voxel_vol = np.prod((bmax - bmin) /
                            np.asarray(res, np.float32))
        inside = native * voxel_vol
        outside = (1.0 - native) * voxel_vol
        return np.stack([inside, outside], -1)
    v0, e1, e2, _ = tri_bank
    X, Y, Z = res
    bmin = jnp.asarray(bbox_min, jnp.float32)
    bmax = jnp.asarray(bbox_max, jnp.float32)
    vs = (bmax - bmin) / jnp.asarray([X, Y, Z], jnp.float32)
    voxel_vol = vs[0] * vs[1] * vs[2]

    offs = (jnp.arange(oversample) + 0.5) / oversample
    frac = jnp.zeros((Z, Y * X), jnp.float32)
    z_edges_lo = bmin[2] + jnp.arange(Z) * vs[2]
    z_edges_hi = z_edges_lo + vs[2]
    z_start = _mesh_z_start(v0, e1, e2, bbox_min)

    for ox in range(oversample):
        for oy in range(oversample):
            xs = bmin[0] + (jnp.arange(X) + offs[ox]) * vs[0]
            ys = bmin[1] + (jnp.arange(Y) + offs[oy]) * vs[1]
            gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
            xy = jnp.stack([gx.ravel(), gy.ravel()], -1)
            cross = _column_crossings(v0, e1, e2, xy, z_start)  # (N, K)
            # inside intervals [t0,t1], [t2,t3], ...
            t_in = cross[:, 0::2]   # (N, K/2)
            t_out = cross[:, 1::2]
            t_out = jnp.where(jnp.isfinite(t_in) & ~jnp.isfinite(t_out),
                              bmax[2] + 1.0, t_out)
            lo = jnp.maximum(z_edges_lo[:, None, None], t_in[None])
            hi = jnp.minimum(z_edges_hi[:, None, None], t_out[None])
            cov = jnp.sum(jnp.maximum(hi - lo, 0.0), -1)  # (Z, N)
            frac = frac + cov / vs[2]

    frac = frac / (oversample * oversample)
    frac = frac.reshape(Z, Y, X)
    inside = frac * voxel_vol
    outside = (1.0 - frac) * voxel_vol
    return jnp.stack([inside, outside], -1)

"""Uniform-grid triangle acceleration for in-kernel mesh intersection.

The wavefront march intersects triangle meshes (targets, occlusions,
custom vials) inside its bounce loop. The brute-force bank sweep
(ops/intersect.ray_triangles) touches every triangle per segment —
fine for the reference's tiny test meshes, quadratic death for
Benchy-class geometry (the reference leans on Embree/OptiX BVHs here,
README.md:97). This module is the JAX accelerator structure:

  * `build_tri_grid` (host, numpy): bins triangles into a uniform 3D
    grid sized to ~2 cells/triangle, stored CSR (cell_start, tri_ids).
    Build is vectorized numpy — ~100 ms for 100k triangles.
  * `ray_triangles_grid` (device, lax): vectorized 3D-DDA cell walk;
    each step gathers only the current cell's triangle list and tests
    it in 8-wide Moeller-Trumbore chunks. No per-lane stacks, no
    recursion — branchless masked state machines, the data-parallel
    replacement for BVH traversal: cells crossed x tris/cell gathers
    instead of T tests.

Same contract as ray_triangles: (t, tri_idx), t = +inf / idx = -1 on
miss, hits strictly beyond per-lane tmin.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

INF = np.float32(np.inf)

# below this the dense sweep is cheaper than grid-walk divergence
GRID_MIN_TRIS = 96


@dataclass(frozen=True)
class TriGridStatic:
    """Static (hashable) metadata of one mesh's grid inside the merged
    scene banks; the array payload lives in arr['grid_*']."""
    res: Tuple[int, int, int]
    cell_offset: int     # into arr['grid_cell_start'] (this grid owns
    #                      n_cells+1 consecutive entries)
    ids_offset: int      # into arr['grid_tri_ids']
    n_ids: int
    bbox_row: int        # into arr['grid_bbox'] (n_grids, 2, 3)


def build_tri_grid(v0, e1, e2, cells_per_tri=2.0, max_res=128):
    """Host-side uniform grid build over a triangle bank.

    Returns (res, cell_start, tri_ids, bmin, bmax) as numpy arrays;
    cell_start has prod(res)+1 entries (CSR over flattened x-major
    cells), tri_ids lists triangle indices per cell.
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    T = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, p1), p2)
    tmax = np.maximum(np.maximum(v0, p1), p2)
    bmin = tmin.min(0)
    bmax = tmax.max(0)
    ext = np.maximum(bmax - bmin, 1e-6)
    # pad so border triangles never index out
    bmin = bmin - 1e-4 * ext
    bmax = bmax + 1e-4 * ext
    ext = bmax - bmin

    vol = float(np.prod(ext))
    lam = (cells_per_tri * T / max(vol, 1e-30)) ** (1.0 / 3.0)
    res = np.clip(np.round(ext * lam).astype(np.int64), 1, max_res)

    # AABB binning over-counts long diagonal slivers (a 45-degree
    # radial sliver's box can cover ~100 cells); halve the resolution
    # until the (tri, cell) pair count is bounded — build time and
    # traversal chunk count both stay tame.
    while True:
        inv_cell = res / ext
        lo = np.clip(((tmin - bmin) * inv_cell).astype(np.int32),
                     0, res - 1)
        hi = np.clip(((tmax - bmin) * inv_cell).astype(np.int32),
                     0, res - 1)
        nx = hi - lo + 1                   # (T, 3) cells per axis
        cnt = nx.prod(1, dtype=np.int64)
        total = int(cnt.sum())
        if total <= 16 * T or int(res.max()) <= 4:
            break
        res = np.maximum(res // 2, 1)

    gx, gy, gz = int(res[0]), int(res[1]), int(res[2])
    n_cells = gx * gy * gz
    tri_rep = np.repeat(np.arange(T, dtype=np.int64), cnt)
    starts = np.zeros(T, np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    loc = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    lx = nx[tri_rep]
    ix = loc % lx[:, 0]
    rem = loc // lx[:, 0]
    iy = rem % lx[:, 1]
    iz = rem // lx[:, 1]
    cell = (lo[tri_rep, 0] + ix) + gx * (
        (lo[tri_rep, 1] + iy) + gy * (lo[tri_rep, 2] + iz))

    order = np.argsort(cell, kind="stable")
    tri_ids = tri_rep[order].astype(np.int32)
    counts = np.bincount(cell, minlength=n_cells)
    cell_start = np.zeros(n_cells + 1, np.int32)
    np.cumsum(counts, out=cell_start[1:])
    return ((gx, gy, gz), cell_start, tri_ids,
            bmin.astype(np.float32), bmax.astype(np.float32))


def ray_triangles_grid(o, d, tmin, v0, e1, e2, cell_start, tri_ids,
                       bmin, bmax, res, chunk=8):
    """Nearest triangle hit via a vectorized 3D-DDA grid walk.

    o, d, tmin: (N, 3)/(N,) rays; v0/e1/e2: the FULL triangle bank the
    grid indexes into; cell_start/tri_ids/bmin/bmax: one grid's arrays
    (build_tri_grid); res: static (gx, gy, gz).
    """
    gx, gy, gz = res
    n_ids = tri_ids.shape[0]
    res_v = jnp.asarray([gx, gy, gz], jnp.int32)
    cell_w = (bmax - bmin) / jnp.asarray([gx, gy, gz], jnp.float32)

    N = o.shape[0]
    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    tb0 = (bmin - o) / safe_d
    tb1 = (bmax - o) / safe_d
    t_enter = jnp.maximum(jnp.max(jnp.minimum(tb0, tb1), -1), tmin)
    t_exit = jnp.min(jnp.maximum(tb0, tb1), -1)
    alive0 = (t_enter <= t_exit) & jnp.isfinite(t_enter)

    eps_t = 1e-5 * jnp.maximum(jnp.abs(t_enter), 1.0)
    p_in = o + (t_enter + eps_t)[..., None] * d
    ivec0 = jnp.clip(((p_in - bmin) / cell_w).astype(jnp.int32),
                     0, res_v - 1)
    step = jnp.where(d > 0, 1, -1).astype(jnp.int32)
    next_b = bmin + (ivec0 + (step > 0)) * cell_w
    tmaxv0 = jnp.where(jnp.abs(d) > 1e-20, (next_b - o) / safe_d, INF)
    tdelta = jnp.abs(cell_w / safe_d)

    t_best0 = jnp.full((N,), INF)
    i_best0 = jnp.full((N,), -1, jnp.int32)

    def mt_test(ids, valid, t_best, i_best):
        """8-wide Moeller-Trumbore on gathered triangle rows."""
        a0 = v0[ids]
        a1 = e1[ids]
        a2 = e2[ids]
        pvec = jnp.cross(d[:, None, :], a2)
        det = jnp.sum(a1 * pvec, -1)
        ok = valid & (jnp.abs(det) > 1e-12)
        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        tvec = o[:, None, :] - a0
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, a1)
        v = jnp.sum(d[:, None, :] * qvec, -1) * inv_det
        t = jnp.sum(a2 * qvec, -1) * inv_det
        ok &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & \
            (t > tmin[:, None])
        t = jnp.where(ok, t, INF)
        j = jnp.argmin(t, axis=-1)
        t_c = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        id_c = jnp.take_along_axis(ids, j[:, None], -1)[:, 0]
        better = t_c < t_best
        return (jnp.where(better, t_c, t_best),
                jnp.where(better, id_c, i_best))

    def cond(c):
        return jnp.any(c["alive"])

    def body(c):
        ivec, tmaxv, alive = c["ivec"], c["tmaxv"], c["alive"]
        t_best, i_best = c["t_best"], c["i_best"]

        flat = ivec[..., 0] + gx * (ivec[..., 1] + gy * ivec[..., 2])
        flat = jnp.clip(flat, 0, gx * gy * gz - 1)
        s = cell_start[flat]
        e = cell_start[flat + 1]
        cnt = jnp.where(alive, e - s, 0)

        def icond(ic):
            k = ic[0]
            return jnp.any(k * chunk < cnt)

        def ibody(ic):
            k, tb, ib = ic
            idx = s[:, None] + k * chunk + jnp.arange(chunk,
                                                      dtype=jnp.int32)
            # bound by the alive-masked count so dead lanes stop
            # gathering/re-testing their stale cell's triangles
            valid = idx < (s + cnt)[:, None]
            ids = tri_ids[jnp.clip(idx, 0, n_ids - 1)]
            tb, ib = mt_test(ids, valid, tb, ib)
            return (k + 1, tb, ib)

        _, t_best, i_best = jax.lax.while_loop(
            icond, ibody, (jnp.int32(0), t_best, i_best))

        t_cell_exit = jnp.min(tmaxv, -1)
        # a hit inside the current cell ends this lane (conservative:
        # accept only hits before the cell exit plane)
        done = t_best <= t_cell_exit * (1.0 + 1e-6) + 1e-6
        # 3D-DDA advance along the nearest exit axis
        axis_min = t_cell_exit[..., None] == tmaxv
        # break ties to a single axis (first true)
        first = jnp.cumsum(axis_min.astype(jnp.int32), -1) == 1
        axis_min = axis_min & first
        ivec_n = ivec + jnp.where(axis_min, step, 0)
        tmaxv_n = tmaxv + jnp.where(axis_min, tdelta, 0.0)
        in_grid = jnp.all((ivec_n >= 0) & (ivec_n < res_v), -1)
        past_end = t_cell_exit > t_exit
        alive_n = alive & ~done & in_grid & ~past_end
        ivec = jnp.where(alive_n[..., None], ivec_n, ivec)
        tmaxv = jnp.where(alive_n[..., None], tmaxv_n, tmaxv)
        return dict(ivec=ivec, tmaxv=tmaxv, alive=alive_n,
                    t_best=t_best, i_best=i_best)

    out = jax.lax.while_loop(cond, body, dict(
        ivec=ivec0, tmaxv=tmaxv0, alive=alive0,
        t_best=t_best0, i_best=i_best0))
    return out["t_best"], out["i_best"]

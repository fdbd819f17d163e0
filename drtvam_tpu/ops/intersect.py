"""Analytic and triangle-mesh ray intersection kernels.

Replaces Mitsuba's shape plugins + BVH/OptiX traversal for the shapes the
TVAM scenes use (reference call site: volume.py:191 `scene.ray_intersect`):
  * open z-aligned cylinder tube (vial walls — geometry.py:152-183)
  * axis-aligned box (square vials — geometry.py:195-219)
  * triangle meshes (targets / occlusions / custom vials), brute-force
    over a flat triangle bank in chunks; TVAM meshes are tiny (<= ~1k
    triangles) so a BVH would cost more in traversal divergence than
    the dense Moeller-Trumbore sweep it saves.

All functions are batched over rays, branchless, and return t = +inf on
miss. Normals are geometric and outward-oriented (not flipped toward the
ray) — the BSDF layer handles sidedness.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

INF = np.float32(np.inf)  # numpy: no device commit at import time


def ray_cylinder(o, d, tmin, r, z0, z1):
    """Open cylinder tube of radius r around the z-axis, z in [z0, z1]."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (a > 1e-20)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / jnp.where(a > 1e-20, a, 1.0)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a

    def pick(t):
        z = oz + t * dz
        return jnp.where(ok & (t > tmin) & (z >= z0) & (z <= z1), t, INF)

    t0v, t1v = pick(t0), pick(t1)
    t = jnp.minimum(t0v, t1v)
    px = ox + t * dx
    py = oy + t * dy
    inv_r = 1.0 / r
    n = jnp.stack([px * inv_r, py * inv_r, jnp.zeros_like(px)], -1)
    return t, n


def ray_box(o, d, tmin, h):
    """Axis-aligned box centered at the origin with half-extents h (3,)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    t_lo = (-h - o) * inv_d
    t_hi = (h - o) * inv_d
    t_near_v = jnp.minimum(t_lo, t_hi)
    t_far_v = jnp.maximum(t_lo, t_hi)
    t_near = jnp.max(t_near_v, axis=-1)
    t_far = jnp.min(t_far_v, axis=-1)
    hit = t_near <= t_far

    t_n = jnp.where(hit & (t_near > tmin), t_near, INF)
    t_f = jnp.where(hit & (t_far > tmin), t_far, INF)
    t = jnp.minimum(t_n, t_f)
    use_near = t == t_n
    # face axis = the slab that bounds the chosen t; outward normal points
    # along that axis with the sign of the hit point coordinate.
    axis = jnp.where(use_near,
                     jnp.argmax(t_near_v, axis=-1),
                     jnp.argmin(t_far_v, axis=-1))
    p = o + t[..., None] * d
    sgn = jnp.sign(jnp.take_along_axis(p, axis[..., None], axis=-1)[..., 0])
    n = jnp.stack(
        [jnp.where(axis == k, sgn, 0.0) for k in range(3)], -1)
    return t, n


def ray_triangles(o, d, tmin, v0, e1, e2, chunk=8):
    """Nearest hit against a triangle bank (T,3) arrays, Moeller-Trumbore.

    Returns (t, tri_idx) with t = inf / idx = -1 on miss. Scans the bank
    in `chunk`-sized blocks inside a fori_loop to bound memory at
    (n_rays, chunk).
    """
    T = v0.shape[0]
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    if pad:
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3), v0.dtype)])
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)])
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)])

    def body(i, carry):
        t_best, i_best = carry
        s = i * chunk
        a0 = jax.lax.dynamic_slice(v0, (s, 0), (chunk, 3))
        a1 = jax.lax.dynamic_slice(e1, (s, 0), (chunk, 3))
        a2 = jax.lax.dynamic_slice(e2, (s, 0), (chunk, 3))
        # broadcast rays (N,1,3) vs tris (1,C,3)
        pvec = jnp.cross(d[:, None, :], a2[None])
        det = jnp.sum(a1[None] * pvec, -1)
        ok = jnp.abs(det) > 1e-12
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = o[:, None, :] - a0[None]
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, a1[None])
        v = jnp.sum(d[:, None, :] * qvec, -1) * inv_det
        t = jnp.sum(a2[None] * qvec, -1) * inv_det
        ok &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & \
            (t > tmin[:, None])
        t = jnp.where(ok, t, INF)
        j = jnp.argmin(t, axis=-1)
        t_c = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        better = t_c < t_best
        t_best = jnp.where(better, t_c, t_best)
        i_best = jnp.where(better, s + j, i_best)
        return t_best, i_best

    t0 = jnp.full(o.shape[:-1], INF)
    i0 = jnp.full(o.shape[:-1], -1, jnp.int32)
    return jax.lax.fori_loop(0, n_chunks, body, (t0, i0))

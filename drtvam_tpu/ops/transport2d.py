"""Per-angle 2D transport fields for the ballistic (non-scattering)
fast path.

A factorization not present in the reference: for a
collimated projector orbiting a z-invariant vial (cylindrical, square,
index-matched, double-cylindrical — every analytic container), a ray's
(x, y) trajectory is independent of its z / DMD row. The entire
volumetric transport therefore factors into

    dose(z, y, x) = sum_a  W_a(y, x) * P_a(z_row, u_map_a(y, x))

where W_a is the per-cell absorbed-dose weight of angle a's 2D ray fan
(Fresnel products x the reference's exact per-voxel Beer-Lambert DDA
deposit, sensor.py:306-440) and u_map_a is the (fractional) DMD column
whose ray feeds that cell. This module precomputes (W, UW) once per
geometry by tracing A x U 2D rays through the interface stack
(transmission-only, volume.py:230-247) and rasterizing each medium
segment with a 2D Amanatides-Woo walk. The per-render work then
becomes a two-tap gather per cell and angle (ops/backproject.py).

Where two adjacent DMD columns' rays cross one cell, the stored
weighted-average column u_map = UW/W makes the downstream linear
interpolation EXACT (w1*P[u] + w2*P[u+1] is recovered); three or more
contributors incur a second-difference interpolation error, negligible
at TVAM pixel/voxel ratios.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .march import MarchStatic, intersect_scene
from .fresnel import refract
from ..models.geometry import DIELECTRIC, NULL

INF = np.float32(np.inf)  # numpy: no device commit at import time


def unscattered_eligible(static: MarchStatic) -> bool:
    """Can the *unscattered* transport of this scene be precomputed as
    per-angle 2D fields? Requires z-invariant deterministic geometry:
    collimated projector, analytic vials, transmission-only BSDFs. A
    target mesh with a null BSDF is allowed (surface-aware films): it
    never deflects rays, it only selects the deposit channel, which the
    engine reproduces with the voxelized inside-mask. Occlusions / mesh
    vials are not z-invariant -> wavefront fallback.

    This is the eligibility test of the HYBRID scattering engine
    (ops/hybrid.py): the expected value of every n_scat == 0 deposit
    equals the analytic per-voxel Beer-Lambert absorption for all three
    reference estimators (dda: exactly, sensor.py:306-440; ratio/delta:
    in expectation, sensor.py:121-295), so the 2D fields replace them
    regardless of the configured estimator."""
    from ..models.geometry import MESH, NULL
    return (
        static.mode == "volume"
        and static.projector.kind == "collimated"
        and static.transmission_only
        and all(s.kind != MESH or (s.is_target and s.bsdf == NULL)
                for s in static.surfaces)
    )


def ballistic_eligible(static: MarchStatic) -> bool:
    """The backprojection fast path covers the reference's headline
    1-ray-per-pixel benchmarks: unscattered-precomputable geometry,
    pure absorption, dda estimator — the whole render is the
    backprojection."""
    return (
        unscattered_eligible(static)
        and not static.has_scattering
        and static.sensor.estimator == "dda"
    )


def strip_target(static: MarchStatic, arr):
    """Remove target surfaces (geometry no-ops for ballistic rays) so
    the 2D trace only sees the z-invariant interfaces."""
    import dataclasses
    keep = [i for i, s in enumerate(static.surfaces) if not s.is_target]
    if len(keep) == len(static.surfaces):
        return static, arr
    idx = np.asarray(keep)
    static2 = dataclasses.replace(
        static, surfaces=tuple(static.surfaces[i] for i in keep))
    arr2 = dict(arr)
    arr2["surf_params"] = arr["surf_params"][idx]
    arr2["surf_eta"] = arr["surf_eta"][idx]
    if "surf_refl" in arr:
        arr2["surf_refl"] = arr["surf_refl"][idx]
    return static2, arr2


def build_transport(static: MarchStatic, arr, supersample: int = 1):
    """Trace the A x U 2D ray fan and rasterize dose weights.

    Returns (W, UW): float32 (A, Y, X) fields. Scalar factors folded
    into W: per-cell (sigma_a/sigma_t) * exp(-st*t) * (1-exp(-st*dt))
    Beer-Lambert absorption and the Fresnel transmission products. The
    ray-weight scalar (pixel_area * print_time) and 1/voxel_volume are
    NOT folded — ops/backproject.py applies them to keep render_raw's
    unnormalized-accumulator contract.
    """
    arr = {k: jnp.asarray(v) for k, v in arr.items()}
    p = static.projector
    A, U = p.n_patterns, p.resx
    X, Y, _ = static.sensor.res
    S = supersample
    n = A * U * S

    lane = jnp.arange(n, dtype=jnp.uint32)
    a_idx = (lane // jnp.uint32(U * S)).astype(jnp.float32)
    rem = lane % jnp.uint32(U * S)
    u_idx = (rem // jnp.uint32(S)).astype(jnp.float32)
    s_idx = (rem % jnp.uint32(S)).astype(jnp.float32)

    alpha = 2.0 * jnp.pi * a_idx / A
    if static.clockwise:
        alpha = -alpha
    dist = arr["motion_distance"]
    origin = dist * jnp.stack(
        [jnp.cos(alpha), jnp.sin(alpha), jnp.zeros_like(alpha)], -1)
    dirw = -origin / dist
    up = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    left = jnp.cross(jnp.broadcast_to(up, dirw.shape), dirw)
    left = left / jnp.linalg.norm(left, axis=-1, keepdims=True)

    ex = U * arr["pixel_size"][0]
    s_u = (u_idx + (s_idx + 0.5) / S) / U         # [0,1) across the row
    cam_x = (0.5 - s_u) * ex
    o = origin + cam_x[..., None] * left
    d = dirw

    bsdf_kind = jnp.asarray([s.bsdf for s in static.surfaces], jnp.int32)
    med_side = jnp.asarray([s.medium_side for s in static.surfaces],
                           jnp.int32)
    st = arr["sigma_t"]
    sa_over_st = 1.0 - arr["albedo"]
    bmin2 = arr["bbox_min"][:2]
    bmax2 = arr["bbox_max"][:2]
    vs2 = (bmax2 - bmin2) / jnp.asarray([X, Y], jnp.float32)
    res2 = jnp.asarray([X, Y], jnp.int32)

    Wf = jnp.zeros((A * Y * X,), jnp.float32)
    UWf = jnp.zeros((A * Y * X,), jnp.float32)
    a_base = (lane // jnp.uint32(U * S)).astype(jnp.int32) * (Y * X)
    u_val = u_idx + (s_idx + 0.5) / S - 0.5       # fractional DMD column

    max_steps = X + Y + 2

    def dda2d(Wf, UWf, o, d, t_base, maxt, amp, active):
        """2D Amanatides-Woo over the (y, x) sensor cross-section,
        depositing amp * (sa/st) * exp(-st*(t_base+t)) * (1-exp(-st*dt))
        and the same times u into the per-angle fields.

        Deposits are staged densely into (max_steps, n) buffers inside
        the loop (contiguous row writes) and flushed with ONE scatter-
        add at the end instead of one scatter per step."""
        o2 = o[..., :2]
        d2 = d[..., :2]
        safe = jnp.where(jnp.abs(d2) > 1e-12, d2, 1e-12)
        t0 = (bmin2 - o2) / safe
        t1 = (bmax2 - o2) / safe
        t_in = jnp.maximum(jnp.max(jnp.minimum(t0, t1), -1), 0.0)
        t_out = jnp.minimum(jnp.min(jnp.maximum(t0, t1), -1), maxt)
        act = active & (t_in < t_out) & jnp.isfinite(t_in) & \
            jnp.isfinite(t_out)

        start = o2 + t_in[..., None] * d2
        stepd = jnp.where(d2 > 0, 1, -1).astype(jnp.int32)
        cell = jnp.clip(((start - bmin2) / vs2).astype(jnp.int32),
                        0, res2 - 1)
        nxt = bmin2 + (cell + stepd) * vs2 + jnp.where(d2 < 0, vs2, 0.0)
        valid_dir = jnp.abs(d2) > 1e-9
        dtm = jnp.where(valid_dir, (nxt - start) / safe, INF)
        dtm = jnp.where(dtm < 0, INF, dtm)
        tstep = jnp.where(valid_dir, vs2 / safe * stepd, INF)

        base = amp * sa_over_st
        n_lanes = o.shape[0]
        idx_buf = jnp.zeros((max_steps, n_lanes), jnp.int32)
        val_buf = jnp.zeros((max_steps, n_lanes), jnp.float32)

        def cond(c):
            i, act, *_ = c
            return jnp.any(act) & (i < max_steps)

        def body(c):
            i, act, cell, dtm, t, rem, idx_buf, val_buf = c
            dt = jnp.minimum(jnp.min(dtm, -1), rem)
            contrib = base * jnp.exp(-st * (t_base + t)) * \
                (1.0 - jnp.exp(-st * jnp.maximum(dt, 0.0)))
            flat = a_base + cell[..., 1] * X + cell[..., 0]
            idx_buf = jax.lax.dynamic_update_index_in_dim(
                idx_buf, jnp.where(act, flat, 0), i, 0)
            val_buf = jax.lax.dynamic_update_index_in_dim(
                val_buf, jnp.where(act, contrib, 0.0), i, 0)
            rem = jnp.where(act, rem - dt, rem)
            act = act & (rem > 1e-7)
            m = dtm == dt[..., None]
            dtm = jnp.where(m, tstep, dtm - dt[..., None])
            cell = jnp.where(act[..., None], cell + jnp.where(m, stepd, 0),
                             cell)
            act = act & jnp.all(cell >= 0, -1) & jnp.all(cell < res2, -1)
            t = jnp.where(act, t + dt, t)
            return (i + 1, act, cell, dtm, t, rem, idx_buf, val_buf)

        c = (jnp.int32(0), act, cell, dtm, t_in, t_out - t_in,
             idx_buf, val_buf)
        c = jax.lax.while_loop(cond, body, c)
        idx_buf, val_buf = c[-2], c[-1]
        idx = idx_buf.ravel()
        val = val_buf.ravel()
        Wf = Wf.at[idx].add(val)
        UWf = UWf.at[idx].add(val * jnp.broadcast_to(u_val,
                                                     idx_buf.shape).ravel())
        return Wf, UWf

    state = dict(
        o=o, d=d, amp=jnp.ones((n,), jnp.float32),
        t_med=jnp.zeros((n,), jnp.float32),
        in_medium=jnp.zeros((n,), jnp.bool_),
        active=jnp.ones((n,), jnp.bool_),
        Wf=Wf, UWf=UWf, it=jnp.int32(0),
    )
    max_iters = 2 * len(static.surfaces) + 2

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_iters)

    def body(s):
        o, d, amp = s["o"], s["d"], s["amp"]
        active, in_medium = s["active"], s["in_medium"]
        t_med, Wf, UWf = s["t_med"], s["Wf"], s["UWf"]

        t_si, n_si, sid, valid = intersect_scene(static, arr, o, d, active)
        active = active & valid
        seg_med = in_medium & active
        Wf, UWf = dda2d(Wf, UWf, o, d, t_med, t_si, amp, seg_med)
        t_med = jnp.where(seg_med, t_med + t_si, t_med)

        kind = bsdf_kind[jnp.clip(sid, 0, None)]
        eta = arr["surf_eta"][jnp.clip(sid, 0, None)]
        d_t, d_r, F, tir, eta_rel = refract(d, n_si, eta)
        w_diel = jnp.where(tir, 0.0, (1.0 - F) / (eta_rel * eta_rel))
        is_diel = kind == DIELECTRIC
        is_null = kind == NULL
        w = jnp.where(is_diel, w_diel, jnp.where(is_null, 1.0, 0.0))
        d_new = jnp.where(is_diel[..., None], d_t, d)

        p_new = o + t_si[..., None] * d
        o = jnp.where(active[..., None], p_new, o)
        d = jnp.where(active[..., None], d_new, d)
        amp = jnp.where(active, amp * w, amp)

        ms = med_side[jnp.clip(sid, 0, None)]
        dn = jnp.sum(d * n_si, -1)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_medium = active & enters
        active = active & (amp > 0.0)
        return dict(o=o, d=d, amp=amp, t_med=t_med, in_medium=in_medium,
                    active=active, Wf=Wf, UWf=UWf, it=s["it"] + 1)

    state = jax.lax.while_loop(cond, body, state)
    W = state["Wf"].reshape(A, Y, X) / S
    UW = state["UWf"].reshape(A, Y, X) / S
    return W, UW


def build_chords(static: MarchStatic, arr, K: int = 2):
    """Per-(angle, DMD column) in-medium chord bank for the forced
    first-scatter residual (march._first_scatter_from_chords).

    For z-invariant transmission-only geometry a pixel's in-medium
    trajectory is a fixed 2D polyline independent of its DMD row and of
    the pattern values — the same factorization build_transport exploits
    for the ballistic dose. This records it explicitly: up to K straight
    medium segments per (a, u) with entry point, direction, length and
    the accumulated Fresnel amplitude at entry. Target surfaces must be
    stripped (strip_target) — a null target crossing would split what is
    physically one chord. After stripping, every surface is a dielectric
    vial wall, so each in-medium intersect step IS one complete segment.

    Returns float32 arrays, laid out for one fused gather per lane:
      seg_o  (A*U, K, 2)  segment entry point (x, y)
      seg_d  (A*U, K, 2)  unit direction (horizontal; dz == 0 exactly)
      seg_L  (A*U, K)     length (0 for absent segments)
      seg_amp(A*U, K)     Fresnel amplitude at segment entry
    """
    arr = {k: jnp.asarray(v) for k, v in arr.items()}
    p = static.projector
    A, U = p.n_patterns, p.resx
    n = A * U

    lane = jnp.arange(n, dtype=jnp.uint32)
    a_idx = (lane // jnp.uint32(U)).astype(jnp.float32)
    u_idx = (lane % jnp.uint32(U)).astype(jnp.float32)

    alpha = 2.0 * jnp.pi * a_idx / A
    if static.clockwise:
        alpha = -alpha
    dist = arr["motion_distance"]
    origin = dist * jnp.stack(
        [jnp.cos(alpha), jnp.sin(alpha), jnp.zeros_like(alpha)], -1)
    dirw = -origin / dist
    up = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    left = jnp.cross(jnp.broadcast_to(up, dirw.shape), dirw)
    left = left / jnp.linalg.norm(left, axis=-1, keepdims=True)
    ex = U * arr["pixel_size"][0]
    cam_x = (0.5 - (u_idx + 0.5) / U) * ex
    o = origin + cam_x[..., None] * left
    d = dirw

    bsdf_kind = jnp.asarray([s.bsdf for s in static.surfaces], jnp.int32)
    med_side = jnp.asarray([s.medium_side for s in static.surfaces],
                           jnp.int32)

    state = dict(
        o=o, d=d, amp=jnp.ones((n,), jnp.float32),
        in_medium=jnp.zeros((n,), jnp.bool_),
        active=jnp.ones((n,), jnp.bool_),
        sg_o=jnp.zeros((n, K, 2), jnp.float32),
        sg_d=jnp.zeros((n, K, 2), jnp.float32),
        sg_L=jnp.zeros((n, K), jnp.float32),
        sg_amp=jnp.zeros((n, K), jnp.float32),
        cnt=jnp.zeros((n,), jnp.int32),
        it=jnp.int32(0),
    )
    max_iters = 2 * len(static.surfaces) + 2

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_iters)

    def body(s):
        o, d, amp = s["o"], s["d"], s["amp"]
        active, in_medium = s["active"], s["in_medium"]

        t_si, n_si, sid, valid = intersect_scene(static, arr, o, d,
                                                 active)
        active = active & valid
        seg = in_medium & active & (s["cnt"] < K)
        onehot = (jnp.arange(K)[None, :] ==
                  jnp.minimum(s["cnt"], K - 1)[:, None]) & seg[:, None]
        sg_o = jnp.where(onehot[..., None], o[:, None, :2], s["sg_o"])
        sg_d = jnp.where(onehot[..., None], d[:, None, :2], s["sg_d"])
        sg_L = jnp.where(onehot, t_si[:, None], s["sg_L"])
        sg_amp = jnp.where(onehot, amp[:, None], s["sg_amp"])
        cnt = s["cnt"] + seg.astype(jnp.int32)

        kind = bsdf_kind[jnp.clip(sid, 0, None)]
        eta = arr["surf_eta"][jnp.clip(sid, 0, None)]
        d_t, _, F, tir, eta_rel = refract(d, n_si, eta)
        w_diel = jnp.where(tir, 0.0, (1.0 - F) / (eta_rel * eta_rel))
        is_diel = kind == DIELECTRIC
        is_null = kind == NULL
        w = jnp.where(is_diel, w_diel, jnp.where(is_null, 1.0, 0.0))
        d_new = jnp.where(is_diel[..., None], d_t, d)

        o = jnp.where(active[..., None], o + t_si[..., None] * d, o)
        d = jnp.where(active[..., None], d_new, d)
        amp = jnp.where(active, amp * w, amp)

        ms = med_side[jnp.clip(sid, 0, None)]
        dn = jnp.sum(d * n_si, -1)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_medium = active & enters
        active = active & (amp > 0.0)
        return dict(o=o, d=d, amp=amp, in_medium=in_medium,
                    active=active, sg_o=sg_o, sg_d=sg_d, sg_L=sg_L,
                    sg_amp=sg_amp, cnt=cnt, it=s["it"] + 1)

    state = jax.lax.while_loop(cond, body, state)
    return (state["sg_o"], state["sg_d"], state["sg_L"],
            state["sg_amp"])


def build_z_resample(static: MarchStatic, arr):
    """(Zf, resy) binning matrix from DMD rows to film z-rows.

    Collimated camera y maps linearly to world z (projector.py:236-240
    + the circular-motion frame): row py's ray travels at constant
    z = (0.5 - (py+0.5)/resy) * resy * pixel_size_y. The reference's 3D
    DDA deposits that whole ray into the voxel CONTAINING its z
    (sensor.py:306-440 with dz = 0) — exact parity is a 0/1 binning
    matrix: Sz[k, r] = 1 iff row r's z falls inside voxel k. Rows sum
    when resy outresolves the film; voxels between ray planes stay
    zero, exactly like the reference.

    With jittered pixel sampling (the reference default), a row's rays
    spread uniformly over the pixel's z-footprint; the EXPECTED dose
    splits across voxels by box overlap — that deterministic
    expectation replaces the reference's Monte-Carlo jitter noise.
    """
    p = static.projector
    resy = p.resy
    _, _, Z = static.sensor.res
    # pull the handful of scalars to host in ONE transfer each:
    # per-element device indexing (arr["pixel_size"][1]) would compile
    # and sync a tiny gather per access
    psize = np.asarray(arr["pixel_size"])
    bmin = np.asarray(arr["bbox_min"])
    bmax = np.asarray(arr["bbox_max"])
    ey = resy * np.float32(psize[1])
    bz0 = float(bmin[2])
    bz1 = float(bmax[2])
    vs_z = (bz1 - bz0) / Z
    ph = float(ey) / resy  # pixel z-footprint
    Sz = np.zeros((Z, resy), np.float32)
    for r in range(resy):
        z_r = (0.5 - (r + 0.5) / resy) * float(ey)
        if static.regular_sampling:
            k = int(np.floor((z_r - bz0) / vs_z))
            if 0 <= k < Z:
                Sz[k, r] = 1.0
        else:
            lo, hi = z_r - 0.5 * ph, z_r + 0.5 * ph
            k0 = int(np.floor((lo - bz0) / vs_z))
            k1 = int(np.floor((hi - bz0) / vs_z + 1.0))
            for k in range(max(k0, 0), min(k1 + 1, Z)):
                vlo, vhi = bz0 + k * vs_z, bz0 + (k + 1) * vs_z
                ov = max(0.0, min(hi, vhi) - max(lo, vlo)) / ph
                if ov > 0:
                    Sz[k, r] = ov
    # plain numpy: this matrix feeds host-side tap-table construction
    # (ballistic._build_z_taps); callers upload if they need it on device
    return Sz

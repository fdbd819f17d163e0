"""The wavefront volumetric path tracer: forward dose + adjoint.

This is the JAX replacement for the reference's Dr.Jit megakernel
(integrators/volume.py:136-282 `sample`) and its per-segment dose
estimators (sensor.py: DDA :306-440, ratio :205-295, delta :121-191).
Instead of a recorded per-lane `while` megakernel, the path loop is a
`lax.while_loop` over a fixed wavefront with per-lane active masks;
everything is branchless and float32.

Estimator semantics replicated exactly (numerically, not bitwise):
  * attenuation tracks Fresnel/BSDF weights and albedo^n_scat only; the
    analytic medium transmittance exp(-sigma_t * t_prev) is applied at
    deposit time in non-scattering mode (the reference keeps it inside
    `attenuation` and "undoes" it with exp(+sigma_t t_prev) — numerically
    identical, ours avoids the exp overflow pair);
  * in scattering mode history transmittance is stochastic (free-flight
    sampling), so deposits carry no t_prev factor;
  * DDA deposits the analytic per-voxel absorption
      A * (sa/st) * em * exp(-st*t) * (1 - exp(-st*dt))
    walking voxels Amanatides-Woo style;
  * ratio tracking marches exponential steps against a majorant with
    weight (sa/st) * (1 - st/M)^k * (st/M);
  * delta deposits A * (sa/st) * em at the sampled interaction voxel.

The backward pass re-traces the same paths (same counter-based RNG
stream, reference volume.py:116) gathering the loss-gradient volume at
each deposit site and accumulating per-lane emitter gradients
(sensor.py:180-186), which segment-sum into pattern gradients.

The `inside_target` parity flip including its documented leak caveat
(volume.py:219) and the medium-transition bookkeeping (volume.py:268)
are preserved.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.rng import Sampler
from .intersect import ray_cylinder, ray_box, ray_triangles
from .mesh_grid import TriGridStatic, ray_triangles_grid
from .fresnel import refract
from .medium import sample_phase_direction, sample_free_flight
from ..models.projector import ProjectorStatic, sample_rays, ray_weight
from ..models.sensor import SensorStatic
from ..models.geometry import CYLINDER, BOX, MESH, DIELECTRIC, NULL, \
    ABSORB, DIFFUSE
from ..core.warp import square_to_cosine_hemisphere

INF = np.float32(np.inf)  # numpy: no device commit at import time
RAY_EPS = 1e-4


def _onb(n):
    """Branchless orthonormal basis around unit vectors n (..., 3)
    (Duff et al. 2017). Returns (tangent, bitangent)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                   -s * n[..., 0]], axis=-1)
    bt = jnp.stack([b, s + n[..., 1] * n[..., 1] * a,
                    -n[..., 1]], axis=-1)
    return t, bt


@dataclass(frozen=True)
class SurfaceStatic:
    kind: int            # CYLINDER | BOX | MESH
    bsdf: int            # DIELECTRIC | NULL | ABSORB | DIFFUSE
    medium_side: int     # 0 none, 1 interior is medium, 2 exterior
    is_target: bool
    tri_slice: Tuple[int, int]  # (start, count) into the triangle bank
    # uniform-grid acceleration for large meshes (ops/mesh_grid.py);
    # None = brute-force bank sweep (tiny meshes)
    grid: Optional[TriGridStatic] = None


@dataclass(frozen=True)
class MarchStatic:
    surfaces: Tuple[SurfaceStatic, ...]
    projector: ProjectorStatic
    sensor: SensorStatic
    has_scattering: bool
    phase: Optional[str]
    max_depth: int
    rr_depth: int
    transmission_only: bool
    regular_sampling: bool
    sample_time: bool
    clockwise: bool
    mode: str = "volume"      # 'volume' | 'radon'
    # Accumulate medium-parameter cotangents (d loss / d sigma_t,
    # d loss / d albedo) in the adjoint, mirroring the reference's
    # st_grad/ss_grad accumulation (volume.py:277-280,
    # sensor.py:180-186): analytic transmittance exp(-st*t_prev) and
    # the scattering power ss^n_scat are re-expressed in the deposit
    # with (st, ss) as differentiable leaves; free-flight sampling
    # pdfs stay detached exactly like the reference. Off by default --
    # it adds VPU work to every adjoint deposit.
    medium_grads: bool = False
    # Scattered-residual mode (the hybrid engine, ops/hybrid.py):
    # trace the identical analog paths but suppress every deposit made
    # with n_scat == 0. The expected value of the suppressed deposits
    # is the deterministic unscattered transport, which the ballistic
    # matmul engine computes analytically (ops/transport2d.py) -- so
    # hybrid = ballistic + scattered_only is an unbiased, strictly
    # lower-variance estimate of the reference's scattering render
    # (volume.py:199-263) at a tiny fraction of the scatter traffic.
    scattered_only: bool = False
    # Forced first-scatter sampling for the scattered residual: instead
    # of tracing the analog path and letting most lanes exit unscattered
    # (at optical depth tau only 1-e^-tau of lanes scatter at all, times
    # albedo of those survive the event — ~19% useful lanes for the
    # albedo-0.5 benchmark), a deterministic RNG-free prologue marches
    # each lane through the transmission-only refraction stack, records
    # its in-medium chord, and importance-samples the first scatter
    # point from the truncated exponential along it with weight
    # albedo * (chord scatter mass). Every lane then starts AT its
    # first scatter event (n_scat=1): identical expectation, ~1/P_scat
    # lower variance per lane, and the pre-scatter march disappears.
    # Only honored when scattered_only & has_scattering &
    # transmission_only; ignored for medium_grads (the forced weight
    # carries extra sigma_t/albedo dependence the cotangent math does
    # not model).
    first_scatter: bool = False
    # Specialized post-first-scatter event loop (set by the hybrid
    # engine when eligible): for a SINGLE convex analytic medium region
    # (one CYLINDER/BOX surface with medium_side == 1 — cylindrical,
    # square and index-matched vials) under transmission-only BSDFs
    # with the delta estimator, a scattered lane is DEAD the moment it
    # reaches the medium boundary: it can never re-enter a convex
    # region on a straight line, and a TIR bounce that could bend it
    # back carries weight 0 in transmission-only mode. The general
    # surface march (intersect bank + BSDF + medium-transition
    # bookkeeping, ~28 while iterations) therefore collapses to
    # max_depth-1 unrolled scatter events with one convex-exit
    # distance each.
    fast_residual: bool = False


# --------------------------------------------------------------------------
# scene intersection over the static surface list


def intersect_scene(static: MarchStatic, arr, o, d, active):
    tmin = jnp.full(o.shape[:-1], RAY_EPS, jnp.float32)
    t_best = jnp.full(o.shape[:-1], INF)
    n_best = jnp.zeros_like(o)
    sid = jnp.full(o.shape[:-1], -1, jnp.int32)
    for i, s in enumerate(static.surfaces):
        if s.kind == CYLINDER:
            t, n = ray_cylinder(o, d, tmin, arr["surf_params"][i, 0],
                                arr["surf_params"][i, 1],
                                arr["surf_params"][i, 2])
        elif s.kind == BOX:
            t, n = ray_box(o, d, tmin, arr["surf_params"][i, :3])
        else:
            a, c = s.tri_slice
            if s.grid is not None:
                g = s.grid
                n_cells = g.res[0] * g.res[1] * g.res[2]
                t, tri = ray_triangles_grid(
                    o, d, tmin,
                    arr["tri_v0"][a:a + c],
                    arr["tri_e1"][a:a + c],
                    arr["tri_e2"][a:a + c],
                    arr["grid_cell_start"][g.cell_offset:
                                           g.cell_offset + n_cells + 1],
                    arr["grid_tri_ids"][g.ids_offset:
                                        g.ids_offset + g.n_ids],
                    arr["grid_bbox"][g.bbox_row, 0],
                    arr["grid_bbox"][g.bbox_row, 1],
                    g.res)
            else:
                t, tri = ray_triangles(o, d, tmin,
                                       arr["tri_v0"][a:a + c],
                                       arr["tri_e1"][a:a + c],
                                       arr["tri_e2"][a:a + c])
            n = arr["tri_n"][a:a + c][jnp.clip(tri, 0, c - 1)]
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        n_best = jnp.where(better[..., None], n, n_best)
        sid = jnp.where(better, i, sid)
    valid = active & jnp.isfinite(t_best)
    return t_best, n_best, sid, valid


def _static_i32(vals):
    return jnp.asarray(vals, jnp.int32)


def _first_scatter_prologue(static: MarchStatic, arr, o, d, sampler,
                            lane, ctr):
    """Deterministic transmission-only prefix + forced first scatter.

    Marches each lane through the refraction stack WITHOUT RNG or
    deposits (the analytic ballistic engine owns the n_scat == 0 dose),
    recording its in-medium chord as up to 2 straight segments
    (origin, direction, length, Fresnel amplitude) — 2 because analytic
    vials yield one medium chord, double-cylindrical two; null/target
    crossings keep direction and amplitude, so they EXTEND the current
    segment exactly instead of splitting it. The first scatter point is
    then importance-sampled from the truncated exponential along the
    chord: pick segment k with probability mass_k / M where
    mass_k = amp_k * exp(-st*tau_k) * (1 - exp(-st*L_k)), then
    t ~ st*exp(-st*t)/(1-exp(-st*L_k)); the lane weight becomes
    albedo * M — the exact expectation of the analog estimator's
    (reach event) x (albedo at event) factor, with zero wasted lanes.

    Returns (o1, d1, A_fs, inside1, alive, ctr): the post-event ray
    state. inside1 is the surface-aware channel flag, initialized from
    the voxelized inside mask (the same convention the analytic
    component uses for its channel split).
    """
    n = o.shape[0]
    st = arr["sigma_t"]
    bsdf_kind = _static_i32([s.bsdf for s in static.surfaces])
    med_side = _static_i32([s.medium_side for s in static.surfaces])
    is_target = jnp.asarray([s.is_target for s in static.surfaces],
                            jnp.bool_)
    K = 2

    state = dict(
        o=o, d=d, amp=jnp.ones((n,), jnp.float32),
        in_medium=jnp.zeros((n,), jnp.bool_),
        active=jnp.ones((n,), jnp.bool_),
        sg_o=jnp.zeros((n, K, 3), jnp.float32),
        sg_d=jnp.zeros((n, K, 3), jnp.float32),
        sg_L=jnp.zeros((n, K), jnp.float32),
        sg_amp=jnp.zeros((n, K), jnp.float32),
        cnt=jnp.zeros((n,), jnp.int32),
        cs_o=jnp.zeros((n, 3), jnp.float32),
        cs_d=jnp.zeros((n, 3), jnp.float32),
        cs_L=jnp.zeros((n,), jnp.float32),
        cs_amp=jnp.zeros((n,), jnp.float32),
        opened=jnp.zeros((n,), jnp.bool_),
        it=jnp.int32(0),
    )
    # target meshes can cross a chord several times; each crossing is
    # one prologue iteration (it extends, not splits, the segment)
    max_iters = 2 * len(static.surfaces) + 8

    def flush(s, close):
        """Write the open segment into slot min(cnt, K-1) for `close`
        lanes and advance cnt."""
        slot = jnp.minimum(s["cnt"], K - 1)
        onehot = (jnp.arange(K)[None, :] == slot[:, None]) & \
            close[:, None]
        sg_o = jnp.where(onehot[..., None], s["cs_o"][:, None, :],
                         s["sg_o"])
        sg_d = jnp.where(onehot[..., None], s["cs_d"][:, None, :],
                         s["sg_d"])
        sg_L = jnp.where(onehot, s["cs_L"][:, None], s["sg_L"])
        sg_amp = jnp.where(onehot, s["cs_amp"][:, None], s["sg_amp"])
        cnt = s["cnt"] + close.astype(jnp.int32)
        return dict(s, sg_o=sg_o, sg_d=sg_d, sg_L=sg_L, sg_amp=sg_amp,
                    cnt=cnt, opened=s["opened"] & ~close)

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_iters)

    def body(s):
        o, d, amp = s["o"], s["d"], s["amp"]
        active, in_medium = s["active"], s["in_medium"]

        t_si, n_si, sid, valid = intersect_scene(static, arr, o, d,
                                                 active)
        active = active & valid
        hit_target = active & is_target[jnp.clip(sid, 0, None)] & \
            (sid >= 0)
        trav = in_medium & active

        # open a segment at the start of an in-medium stretch
        newseg = trav & ~s["opened"]
        s = dict(s,
                 cs_o=jnp.where(newseg[..., None], o, s["cs_o"]),
                 cs_d=jnp.where(newseg[..., None], d, s["cs_d"]),
                 cs_amp=jnp.where(newseg, amp, s["cs_amp"]),
                 cs_L=jnp.where(newseg, 0.0, s["cs_L"]),
                 opened=s["opened"] | newseg)
        s = dict(s, cs_L=jnp.where(trav, s["cs_L"] + t_si, s["cs_L"]))

        # transmission-only BSDF (prologue never reflects)
        kind = bsdf_kind[jnp.clip(sid, 0, None)]
        eta = arr["surf_eta"][jnp.clip(sid, 0, None)]
        d_t, _, F, tir, eta_rel = refract(d, n_si, eta)
        is_diel = kind == DIELECTRIC
        is_null = kind == NULL
        w = jnp.where(is_diel,
                      jnp.where(tir, 0.0, (1.0 - F) /
                                (eta_rel * eta_rel)),
                      jnp.where(is_null, 1.0, 0.0))
        d_new = jnp.where(is_diel[..., None], d_t, d)

        o = jnp.where(active[..., None], o + t_si[..., None] * d, o)
        d = jnp.where(active[..., None], d_new, d)
        amp = jnp.where(active, amp * w, amp)

        ms = med_side[jnp.clip(sid, 0, None)]
        dn = jnp.sum(d * n_si, -1)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_med_next = active & (hit_target | enters)

        # the stretch ends when the direction changes or the medium
        # does; a null/target crossing that stays in medium with the
        # same direction extends it instead
        close = s["opened"] & trav & (is_diel | ~in_med_next)
        s = flush(s, close)

        active = active & (amp > 0.0)
        return dict(s, o=o, d=d, amp=amp, in_medium=in_med_next,
                    active=active, it=s["it"] + 1)

    state = jax.lax.while_loop(cond, body, state)
    state = flush(state, state["opened"])  # max_iters safety flush

    return _sample_first_scatter(static, arr, state["sg_o"],
                                 state["sg_d"], state["sg_L"],
                                 state["sg_amp"], sampler, lane, ctr)


def _first_scatter_from_chords(static: MarchStatic, arr, o, aidx,
                               sampler, lane, ctr):
    """Chord-bank first-scatter prologue: O(1) gathers per lane.

    For z-invariant transmission-only geometry the in-medium chord of a
    pixel's ray is a fixed horizontal 2D polyline independent of its DMD
    row (the factorization transport2d.build_transport exploits), so the
    geometric prologue march collapses to a lookup: gather the (angle,
    column) entry of the precomputed bank (transport2d.build_chords,
    stashed in arr as chord_o/d/L/amp by the hybrid engine) and lift it
    to 3D at the lane's jittered z. The chord is evaluated at the pixel
    CENTER column (midpoint quadrature over the pixel footprint — the
    same determinism the ballistic component applies to the unscattered
    dose); z keeps the exact per-lane jitter.
    """
    p = static.projector
    U, h = p.resx, p.resy
    idx = aidx if p.identity else arr["active_pixels"][aidx]
    emitter = idx // jnp.int32(h * U)
    px = (idx % jnp.int32(h * U)) % jnp.int32(U)
    cid = emitter * jnp.int32(U) + px
    z = o[:, 2:3]
    zeros = jnp.zeros_like(z)
    # ONE packed-record gather instead of four: separate per-field
    # gathers each pay the full random-access cost. The pack is
    # loop-invariant, so XLA hoists it out of the chunk loop when the
    # engine didn't prepack on host.
    if "chord_pack" in arr:
        rec = arr["chord_pack"]
    else:
        n_cid = arr["chord_L"].shape[0]
        rec = jnp.concatenate(
            [arr["chord_o"].reshape(n_cid, 4),
             arr["chord_d"].reshape(n_cid, 4),
             arr["chord_L"], arr["chord_amp"]], axis=1)
    rec = rec[cid]                                   # (n, 12)
    co = rec[:, 0:4].reshape(-1, 2, 2)
    cd = rec[:, 4:8].reshape(-1, 2, 2)
    sg_o = jnp.concatenate([co, jnp.broadcast_to(z[:, None], co[..., :1].shape)], -1)
    sg_d = jnp.concatenate([cd, jnp.broadcast_to(zeros[:, None], cd[..., :1].shape)], -1)
    return _sample_first_scatter(static, arr, sg_o, sg_d,
                                 rec[:, 8:10], rec[:, 10:12],
                                 sampler, lane, ctr)


def _sample_first_scatter(static: MarchStatic, arr, sg_o, sg_d, sg_L,
                          sg_amp, sampler, lane, ctr):
    """Importance-sample the first scatter event from K=2 recorded
    in-medium segments; see _first_scatter_prologue for the weight
    derivation. Returns (o1, d1, A_fs, inside1, alive, ctr)."""
    n = sg_L.shape[0]
    st = arr["sigma_t"]
    tau = jnp.concatenate([jnp.zeros((n, 1)), sg_L[:, :1]], axis=1)
    mass = sg_amp * jnp.exp(-st * tau) * (1.0 - jnp.exp(-st * sg_L))
    M = jnp.sum(mass, axis=1)
    alive = M > 1e-12

    u1, ctr = sampler.next_1d(lane, ctr)
    pick1 = (u1 * M > mass[:, 0]) & (sg_L[:, 1] > 0.0)
    # K == 2: a where-select, NOT take_along_axis — the latter lowers
    # to a per-lane gather; the select fuses into its neighbours
    take = lambda a: jnp.where(
        pick1[:, None] if a.ndim == 3 else pick1, a[:, 1], a[:, 0])
    o_k, d_k = take(sg_o), take(sg_d)
    L_k, m_k = take(sg_L), take(mass)
    um = jnp.clip((u1 * M - jnp.where(pick1, mass[:, 0], 0.0)) /
                  jnp.maximum(m_k, 1e-30), 0.0, 1.0 - 1e-7)
    t_ev = -jnp.log1p(-um * (1.0 - jnp.exp(-st * L_k))) / \
        jnp.maximum(st, 1e-30)
    t_ev = jnp.clip(t_ev, 0.0, L_k)
    o1 = o_k + t_ev[..., None] * d_k

    u2, ctr = sampler.next_2d(lane, ctr)
    d1 = sample_phase_direction(static.phase, arr["phase_g"], d_k,
                                u2[..., 0], u2[..., 1])
    A_fs = arr["albedo"] * M

    if static.sensor.channels == 2:
        X, Y, Z = static.sensor.res
        bmin, bmax = arr["bbox_min"], arr["bbox_max"]
        inv_vs = jnp.asarray([X, Y, Z], jnp.float32) / (bmax - bmin)
        v = jnp.floor((o1 - bmin) * inv_vs).astype(jnp.int32)
        in_grid = jnp.all(v >= 0, -1) & \
            jnp.all(v < jnp.asarray([X, Y, Z], jnp.int32), -1)
        flat = v[..., 0] + X * (v[..., 1] + Y * v[..., 2])
        mask = arr["inside_mask_flat"]
        inside1 = jnp.where(in_grid,
                            mask[jnp.where(in_grid, flat, 0)] > 0.5,
                            False)
    else:
        inside1 = jnp.zeros((n,), jnp.bool_)
    return o1, d1, A_fs, inside1, alive, ctr


def fast_residual_eligible(static: MarchStatic) -> bool:
    """See MarchStatic.fast_residual. True when the medium region is a
    single convex analytic volume: exactly one non-target surface with
    medium_side != 0, of CYLINDER or BOX kind with medium_side == 1."""
    med = [s for s in static.surfaces
           if s.medium_side != 0 and not s.is_target]
    return (len(med) == 1 and med[0].medium_side == 1
            and med[0].kind in (CYLINDER, BOX))


def _fast_residual_loop(static: MarchStatic, arr, o, d, A, em, sampler,
                        lane, ctr, alive, primal, acc, g, dL):
    """Unrolled scatter-event loop for the forced-first-scatter delta
    residual in a single convex medium (see MarchStatic.fast_residual).

    State enters AT the forced first scatter event (post-phase-sample):
    per event, sample the free flight against the convex exit distance
    (one quadratic / slab test — lanes reaching the boundary die),
    stage the delta deposit A * (1-albedo) * em at the event voxel
    (sensor.py:121-191 via delta_segment's weights), attenuate by
    albedo, Russian-roulette past rr_depth, and phase-sample the new
    direction. Deposits flush with ONE batched scatter-add (primal) /
    gather-sum (adjoint) at the end. Event count: the forced event is
    depth 1 and the reference's depth cap kills paths at max_depth
    (volume.py:181-199), so up to max_depth - 1 more events run.
    """
    n = o.shape[0]
    st = arr["sigma_t"]
    al = arr["albedo"]
    med_i = [i for i, s in enumerate(static.surfaces)
             if s.medium_side != 0 and not s.is_target][0]
    med = static.surfaces[med_i]
    med_p = arr["surf_params"][med_i]
    bmin, bmax = arr["bbox_min"], arr["bbox_max"]
    X, Y, Z = static.sensor.res
    inv_vs = jnp.asarray([X, Y, Z], jnp.float32) / (bmax - bmin)
    surf_aware = static.sensor.channels == 2
    if surf_aware:
        mask = arr["inside_mask_flat"]

    if med.kind == CYLINDER:
        r, z0, z1 = med_p[0], med_p[1], med_p[2]

        def exit_dist(o, d):
            # far root of the side quadratic (origin inside the tube)
            ox, oy = o[..., 0], o[..., 1]
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            a = dx * dx + dy * dy
            b = 2.0 * (ox * dx + oy * dy)
            c = ox * ox + oy * oy - r * r
            disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
            t_side = jnp.where(a > 1e-20,
                               (-b + jnp.sqrt(disc)) * 0.5 /
                               jnp.maximum(a, 1e-20), INF)
            # the tube is OPEN: a (near-vertical) lane whose side exit
            # lies beyond the z-caps hits nothing, and both the general
            # march and the reference (volume.py:193 `active &=
            # si.is_valid()`) kill it WITHOUT a medium event — return 0
            # so it dies here too. (Approximation vs the reference when
            # a target mesh sits in front: events before that crossing
            # would still deposit there; sub-percent of the residual.)
            z_hit = o[..., 2] + t_side * dz
            ok = jnp.isfinite(t_side) & (z_hit >= z0) & (z_hit <= z1)
            return jnp.where(ok, jnp.maximum(t_side, 0.0), 0.0)
    else:
        h = med_p[:3]

        def exit_dist(o, d):
            inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
            t_lo = (-h - o) * inv_d
            t_hi = (h - o) * inv_d
            t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
            return jnp.maximum(t_far, 0.0)

    E = max(static.max_depth - 1, 0)
    idx_rows, val_rows = [], []
    inv_st = 1.0 / jnp.maximum(st, 1e-30)
    base_w = (1.0 - al) * (em if primal else 1.0)

    for j in range(E):
        # RNG draws mirror the general loop's per-iteration order
        # (u_rr, u_ff, u_b, u_ph) so a same-seed run replays the same
        # trajectories — the equivalence test in tests/test_hybrid.py
        # relies on it, and the adjoint replays either loop identically.
        u_rr, ctr = sampler.next_1d(lane, ctr)
        if j + 1 > static.rr_depth:  # depth = j+1 at iteration start
            q = jnp.minimum(0.99, A)
            survive = u_rr < q
            A = jnp.where(alive & survive,
                          A / jnp.maximum(q, 1e-12), A)
            alive = alive & survive
        t_exit = exit_dist(o, d)
        u, ctr = sampler.next_1d(lane, ctr)
        t = -jnp.log1p(-jnp.clip(u, 0.0, 1.0 - 1e-7)) * inv_st
        hit = alive & (t < t_exit)
        p = o + t[..., None] * d

        if surf_aware:
            v = jnp.floor((p - bmin) * inv_vs).astype(jnp.int32)
            ing = jnp.all(v >= 0, -1) & \
                jnp.all(v < jnp.asarray([X, Y, Z], jnp.int32), -1)
            fl = v[..., 0] + X * (v[..., 1] + Y * v[..., 2])
            inside = jnp.where(ing,
                               mask[jnp.where(ing, fl, 0)] > 0.5, False)
        else:
            inside = jnp.zeros((n,), jnp.bool_)
        flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, inside)
        m = hit & in_grid
        idx_rows.append(jnp.where(m, flat, 0))
        val_rows.append(jnp.where(m, A * base_w, 0.0))

        A = jnp.where(hit, A * al, A)
        _, ctr = sampler.next_1d(lane, ctr)   # u_b slot (BSDF, unused)
        u_ph, ctr = sampler.next_2d(lane, ctr)
        d = sample_phase_direction(static.phase, arr["phase_g"], d,
                                   u_ph[..., 0], u_ph[..., 1])
        o = p
        alive = hit

    if E > 0:
        idx_buf = jnp.stack(idx_rows)
        val_buf = jnp.stack(val_rows)
        if primal:
            acc = acc.at[idx_buf.ravel()].add(val_buf.ravel())
        else:
            g = g + jnp.sum(val_buf * dL[idx_buf], axis=0)
    return acc, g, ctr


# --------------------------------------------------------------------------
# dose estimators: one straight segment [o, o + maxt*d]


def _voxel_flat(static: MarchStatic, p, bbox_min, inv_vs, inside_target):
    X, Y, Z = static.sensor.res
    C = static.sensor.channels
    v = jnp.floor((p - bbox_min) * inv_vs).astype(jnp.int32)
    in_grid = jnp.all(v >= 0, -1) & \
        jnp.all(v < jnp.asarray([X, Y, Z], jnp.int32), -1)
    flat = v[..., 0] + X * (v[..., 1] + Y * v[..., 2])
    if C == 2:
        flat = 2 * flat + jnp.where(inside_target, 0, 1)
    return flat, in_grid


def _deposit(primal, acc, g, dL, flat, val, mask):
    """primal: scatter-add val into acc; adjoint: gather dL, add to g."""
    idx = jnp.where(mask, flat, 0)
    if primal:
        acc = acc.at[idx].add(jnp.where(mask, val, 0.0))
        return acc, g
    gathered = dL[idx]
    g = g + jnp.where(mask, val * gathered, 0.0)
    return acc, g


# Staged-deposit flush width: DDA/ratio steps buffer (idx, val) rows and
# flush ONE batched scatter-add / gather per K steps instead of one
# scatter per step.
DDA_FLUSH = 32


def dda_segment(static, arr, primal, acc, g, dL, o, d, t_prev, maxt,
                A, em, inside_target, active, n_scat=None, sg=None):
    """Amanatides-Woo voxel walk with analytic per-voxel absorption
    (reference sensor.py:306-440). sg: optional (stg, ssg) scalar
    accumulators for medium-parameter cotangents (adjoint only)."""
    X, Y, Z = static.sensor.res
    bmin, bmax = arr["bbox_min"], arr["bbox_max"]
    vs = (bmax - bmin) / jnp.asarray([X, Y, Z], jnp.float32)
    res = jnp.asarray([X, Y, Z], jnp.int32)
    st = arr["sigma_t"]
    sa_over_st = 1.0 - arr["albedo"]

    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    t_b0 = (bmin - o) / safe_d
    t_b1 = (bmax - o) / safe_d
    mint_box = jnp.maximum(jnp.max(jnp.minimum(t_b0, t_b1), -1), 0.0)
    maxt_box = jnp.min(jnp.maximum(t_b0, t_b1), -1)
    t_start = jnp.maximum(mint_box, 0.0)
    t_end = jnp.minimum(maxt_box, maxt)
    active = active & jnp.isfinite(t_start) & jnp.isfinite(t_end) & \
        (t_start < t_end)

    grid_start = o + t_start[..., None] * d
    grid_end = o + t_end[..., None] * d
    step_dir = jnp.where(d > 0, 1, -1).astype(jnp.int32)
    start_voxel = jnp.clip(((grid_start - bmin) / vs).astype(jnp.int32),
                           0, res - 1)
    end_voxel = jnp.clip(((grid_end - bmin) / vs).astype(jnp.int32),
                         0, res - 1)
    next_voxel_pos = bmin + (start_voxel + step_dir) * vs + \
        jnp.where(d < 0, vs, 0.0)
    valid_dir = jnp.abs(d) > 1e-8
    dtmax = jnp.where(valid_dir, (next_voxel_pos - grid_start) / safe_d, INF)
    dtmax = jnp.where(dtmax < 0, INF, dtmax)
    tstep = jnp.where(valid_dir, vs / safe_d * step_dir, INF)

    # history transmittance: analytic in pure-absorption mode, stochastic
    # (via free-flight sampling) when scattering
    if static.has_scattering:
        hist = A
    else:
        hist = A * jnp.exp(-st * t_prev)
    base = hist * sa_over_st * (em if primal else 1.0)
    want_sigma = (not primal) and static.medium_grads and sg is not None
    if want_sigma:
        hist_em = hist * em
        ss = arr["albedo"] * st
        k = n_scat if (static.has_scattering and n_scat is not None) \
            else None

    X_, Y_, Z_ = static.sensor.res
    C = static.sensor.channels
    max_steps = X_ + Y_ + Z_ + 2
    chan = jnp.where(inside_target, 0, 1) if C == 2 else None

    def advance(act, voxel, dtmax, t, remaining):
        """One Amanatides-Woo step; returns the step's (dt, flat voxel
        index, pre-step active mask) plus the advanced walk state."""
        dt = jnp.minimum(jnp.min(dtmax, -1), remaining)
        flat = voxel[..., 0] + X_ * (voxel[..., 1] + Y_ * voxel[..., 2])
        if C == 2:
            flat = 2 * flat + chan
        dep_act = act
        remaining = jnp.where(act, remaining - dt, remaining)
        act = act & jnp.any(end_voxel != voxel, -1) & (remaining > 1e-6)
        mask = dtmax == dt[..., None]
        dtmax = jnp.where(mask, tstep, dtmax - dt[..., None])
        upd = jnp.where(mask, step_dir, 0)
        voxel = jnp.where(act[..., None], voxel + upd, voxel)
        act = act & jnp.all(voxel >= 0, -1) & jnp.all(voxel < res, -1)
        t_new = jnp.where(act, t + dt, t)
        return dt, flat, dep_act, (act, voxel, dtmax, t_new, remaining)

    stg0, ssg0 = (sg if sg is not None
                  else (jnp.float32(0.0), jnp.float32(0.0)))

    if want_sigma:
        # per-step path: the medium-parameter cotangents need per-step
        # (t, dt) alongside the gathered adjoint, so keep the gather
        # inside the loop (calibration mode, not the hot path)
        def cond(carry):
            i, act, *_ = carry
            return jnp.any(act) & (i < max_steps)

        def body(carry):
            i, act, voxel, dtmax, t, remaining, acc, g, stg, ssg = carry
            t_at = t
            dt, flat, dep_act, (act, voxel, dtmax, t, remaining) = \
                advance(act, voxel, dtmax, t, remaining)
            E = jnp.exp(-st * t_at)
            expdt = jnp.exp(-st * jnp.maximum(dt, 0.0))
            G = 1.0 - expdt
            contrib = base * E * G
            acc, g = _deposit(primal, acc, g, dL, flat, contrib, dep_act)
            # c(st, ss) = hist*em * (st-ss)/st * e^{-st(t_prev+t)} *
            # (1 - e^{-st dt}); partials at the detached point
            # (reference sensor.py:395-423)
            gathered = jnp.where(dep_act,
                                 dL[jnp.where(dep_act, flat, 0)], 0.0)
            HG = hist_em * E * G
            c_full = HG * sa_over_st
            dst = -c_full * (t_prev + t_at) + HG * (arr["albedo"] / st) + \
                hist_em * E * sa_over_st * jnp.maximum(dt, 0.0) * expdt
            dss = -HG / st
            if k is not None:
                dss = dss + jnp.where(ss > 0, c_full * k /
                                      jnp.maximum(ss, 1e-30), 0.0)
            stg = stg + jnp.sum(dst * gathered)
            ssg = ssg + jnp.sum(dss * gathered)
            return (i + 1, act, voxel, dtmax, t, remaining, acc, g,
                    stg, ssg)

        carry = (jnp.int32(0), active, start_voxel, dtmax, t_start,
                 t_end - t_start, acc, g, stg0, ssg0)
        carry = jax.lax.while_loop(cond, body, carry)
        return carry[6], carry[7], (carry[8], carry[9])

    # staged fast path: buffer DDA_FLUSH steps of (idx, val) rows, then
    # ONE batched scatter-add (primal) / gather+reduce (adjoint) per
    # round — SURVEY §7.3's binned-accumulation mitigation
    K = min(DDA_FLUSH, max_steps)
    n_lanes = o.shape[0]
    n_rounds = -(-max_steps // K)

    def cond(carry):
        r, act, *_ = carry
        return jnp.any(act) & (r < n_rounds)

    def round_body(carry):
        r, act, voxel, dtmax, t, remaining, acc, g = carry
        idx_buf = jnp.zeros((K, n_lanes), jnp.int32)
        val_buf = jnp.zeros((K, n_lanes), jnp.float32)

        def step(j, c):
            act, voxel, dtmax, t, remaining, idx_buf, val_buf = c
            t_at = t
            dt, flat, dep_act, (act, voxel, dtmax, t, remaining) = \
                advance(act, voxel, dtmax, t, remaining)
            contrib = base * jnp.exp(-st * t_at) * \
                (1.0 - jnp.exp(-st * jnp.maximum(dt, 0.0)))
            idx_buf = jax.lax.dynamic_update_index_in_dim(
                idx_buf, jnp.where(dep_act, flat, 0), j, 0)
            val_buf = jax.lax.dynamic_update_index_in_dim(
                val_buf, jnp.where(dep_act, contrib, 0.0), j, 0)
            return (act, voxel, dtmax, t, remaining, idx_buf, val_buf)

        act, voxel, dtmax, t, remaining, idx_buf, val_buf = \
            jax.lax.fori_loop(0, K, step, (act, voxel, dtmax, t,
                                           remaining, idx_buf, val_buf))
        if primal:
            acc = acc.at[idx_buf.ravel()].add(val_buf.ravel())
        else:
            g = g + jnp.sum(val_buf * dL[idx_buf], axis=0)
        return (r + 1, act, voxel, dtmax, t, remaining, acc, g)

    carry = (jnp.int32(0), active, start_voxel, dtmax, t_start,
             t_end - t_start, acc, g)
    carry = jax.lax.while_loop(cond, round_body, carry)
    return carry[6], carry[7], (stg0, ssg0)


def ratio_segment(static, arr, primal, acc, g, dL, o, d, t_prev, maxt,
                  A, em, inside_target, active, sampler, lane, ctr,
                  n_scat=None, sg=None):
    """Ratio-tracking estimator (reference sensor.py:205-295)."""
    st = arr["sigma_t"]
    sa_over_st = 1.0 - arr["albedo"]
    M = arr["majorant"]
    bmin, bmax = arr["bbox_min"], arr["bbox_max"]
    X, Y, Z = static.sensor.res
    vs = (bmax - bmin) / jnp.asarray([X, Y, Z], jnp.float32)
    inv_vs = 1.0 / vs

    if static.has_scattering:
        hist = A
    else:
        hist = A * jnp.exp(-st * t_prev)
    base = hist * sa_over_st * (em if primal else 1.0) * (st / M)
    log_ratio = jnp.log(jnp.maximum(1.0 - st / M, 1e-30))
    want_sigma = (not primal) and static.medium_grads and sg is not None
    if want_sigma:
        hist_em = hist * em
        ss = arr["albedo"] * st
        ksc = n_scat if (static.has_scattering and n_scat is not None) \
            else None

    n = o.shape[0]
    stg0, ssg0 = (sg if sg is not None
                  else (jnp.float32(0.0), jnp.float32(0.0)))

    def track(act, t, k, ctr):
        """One exponential tracking step; returns the step's deposit
        (flat index, ratio weight, mask) plus advanced state."""
        u, ctr = sampler.next_1d(lane, ctr)
        t = jnp.where(act, t + sample_free_flight(u, M), t)
        act = act & (t < maxt)
        p = o + t[..., None] * d
        flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, inside_target)
        ratio_k = jnp.exp(k * log_ratio)
        mask = act & in_grid
        k_new = jnp.where(act, k + 1.0, k)
        return flat, ratio_k, mask, (act, t, k_new, ctr)

    if static.medium_grads:
        # per-step path: medium cotangents need per-step k alongside
        # the gathered adjoint (calibration mode, not the hot path).
        # Branch on the STATIC flag, not want_sigma: the primal and the
        # adjoint must consume identical sampler-counter sequences per
        # segment (path replay, volume.py:116), so both sides must run
        # the same loop structure.
        def cond(carry):
            i, act, *_ = carry
            return jnp.any(act) & (i < 65536)

        def body(carry):
            i, act, t, k, ctr, acc, g, stg, ssg = carry
            k_at = k
            flat, ratio_k, mask, (act, t, k, ctr) = track(act, t, k, ctr)
            contrib = base * ratio_k
            acc, g = _deposit(primal, acc, g, dL, flat, contrib, mask)
            if want_sigma:
                # c(st, ss) = hist*em * (st-ss) * (1-st/M)^k / M *
                # e^{-st t_prev}; the st/st cancellation makes the pdf
                # factor drop out (reference sensor.py:276-291)
                gathered = jnp.where(mask, dL[jnp.where(mask, flat, 0)],
                                     0.0)
                H4 = hist_em * ratio_k / M
                c_full = contrib * em
                dst = -c_full * t_prev - \
                    c_full * k_at / jnp.maximum(M - st, 1e-30) + H4
                dss = -H4
                if ksc is not None:
                    dss = dss + jnp.where(ss > 0, c_full * ksc /
                                          jnp.maximum(ss, 1e-30), 0.0)
                stg = stg + jnp.sum(dst * gathered)
                ssg = ssg + jnp.sum(dss * gathered)
            return (i + 1, act, t, k, ctr, acc, g, stg, ssg)

        carry = (jnp.int32(0), active, jnp.zeros((n,), jnp.float32),
                 jnp.zeros((n,), jnp.float32), ctr, acc, g, stg0, ssg0)
        carry = jax.lax.while_loop(cond, body, carry)
        return carry[5], carry[6], carry[4], (carry[7], carry[8])

    # staged fast path: buffer K tracking steps, one batched flush per
    # round (see dda_segment)
    K = 8

    def cond(carry):
        r, act, *_ = carry
        return jnp.any(act) & (r < 65536 // K)

    def round_body(carry):
        r, act, t, k, ctr, acc, g = carry
        idx_buf = jnp.zeros((K, n), jnp.int32)
        val_buf = jnp.zeros((K, n), jnp.float32)

        def step(j, c):
            act, t, k, ctr, idx_buf, val_buf = c
            flat, ratio_k, mask, (act, t, k, ctr) = track(act, t, k, ctr)
            idx_buf = jax.lax.dynamic_update_index_in_dim(
                idx_buf, jnp.where(mask, flat, 0), j, 0)
            val_buf = jax.lax.dynamic_update_index_in_dim(
                val_buf, jnp.where(mask, base * ratio_k, 0.0), j, 0)
            return (act, t, k, ctr, idx_buf, val_buf)

        act, t, k, ctr, idx_buf, val_buf = jax.lax.fori_loop(
            0, K, step, (act, t, k, ctr, idx_buf, val_buf))
        if primal:
            acc = acc.at[idx_buf.ravel()].add(val_buf.ravel())
        else:
            g = g + jnp.sum(val_buf * dL[idx_buf], axis=0)
        return (r + 1, act, t, k, ctr, acc, g)

    carry = (jnp.int32(0), active, jnp.zeros((n,), jnp.float32),
             jnp.zeros((n,), jnp.float32), ctr, acc, g)
    carry = jax.lax.while_loop(cond, round_body, carry)
    return carry[5], carry[6], carry[4], (stg0, ssg0)


def delta_segment(static, arr, primal, acc, g, dL, o, d, t_prev, mei_t,
                  A, em, inside_target, active, n_scat=None, sg=None):
    """Delta-tracking deposit at the sampled interaction point
    (reference sensor.py:121-191). Importance-sampled transmittance
    cancels: contribution = A * (sa/st) * em."""
    st = arr["sigma_t"]
    sa_over_st = 1.0 - arr["albedo"]
    bmin, bmax = arr["bbox_min"], arr["bbox_max"]
    X, Y, Z = static.sensor.res
    vs = (bmax - bmin) / jnp.asarray([X, Y, Z], jnp.float32)
    inv_vs = 1.0 / vs

    act = active & jnp.isfinite(mei_t)
    p = o + mei_t[..., None] * d
    flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, inside_target)
    if static.has_scattering:
        hist = A
    else:
        hist = A * jnp.exp(-st * t_prev)
    contrib = hist * sa_over_st * (em if primal else 1.0)
    mask = act & in_grid
    acc, g = _deposit(primal, acc, g, dL, flat, contrib, mask)
    if (not primal) and static.medium_grads and sg is not None:
        # c(st, ss) = hist*em * (st-ss) * e^{-st(t_prev+t_m)} /
        # detach(e^{-st t_m} st): tr attached, inv_pdf detached
        # (reference sensor.py:169-186)
        gathered = jnp.where(mask, dL[jnp.where(mask, flat, 0)], 0.0)
        hist_em = hist * em
        ss = arr["albedo"] * st
        c_full = hist_em * sa_over_st
        H3 = hist_em / st
        t_m = jnp.where(jnp.isfinite(mei_t), mei_t, 0.0)
        dst = -c_full * (t_prev + t_m) + H3
        dss = -H3
        if static.has_scattering and n_scat is not None:
            dss = dss + jnp.where(ss > 0, c_full * n_scat /
                                  jnp.maximum(ss, 1e-30), 0.0)
        stg, ssg = sg
        sg = (stg + jnp.sum(dst * gathered),
              ssg + jnp.sum(dss * gathered))
    return acc, g, sg if sg is not None else (jnp.float32(0.0),
                                              jnp.float32(0.0))


# --------------------------------------------------------------------------
# the bounce loop


def trace_wavefront(static: MarchStatic, arr, lane, seed, spp,
                    dL_flat=None, acc=None, n_valid=None, em=None):
    """Trace one wavefront chunk.

    Returns (acc, g, L_radon, (stg, ssg)):
      primal 'volume':  acc = flat dose accumulator (updated)
      adjoint 'volume': g = per-lane emitter gradient (excludes em);
                        (stg, ssg) = summed (d loss/d sigma_t_leaf,
                        d loss/d sigma_s_leaf) when
                        static.medium_grads (else zeros)
      'radon':          L_radon = per-lane accumulated in-target absorption

    n_valid: lanes with id >= n_valid are padding and stay inactive.
    em: optional per-lane emitted intensity (BEFORE the ray-weight
    scalar). When lanes are pixel-contiguous the caller can produce it
    with a dynamic-slice of active_data (ops/render._forward) — far
    cheaper than the random-access 64M-table gather done here otherwise.
    """
    primal = dL_flat is None
    # numpy (or custom_vjp-wrapped) leaves -> device arrays: scene dicts
    # are built host-side (models/scene.py) and must be usable both as
    # jit arguments and eagerly
    arr = {k: jnp.asarray(v) for k, v in arr.items()}
    n = lane.shape[0]
    sampler = Sampler(seed)
    ctr = sampler.init(n)

    parr = arr
    o, d, aidx, ctr = sample_rays(
        static.projector, parr, arr["active_pixels"], lane, spp, sampler,
        ctr, static.regular_sampling, static.sample_time, static.clockwise)

    w_scalar = ray_weight(static.projector, parr, spp, arr["print_time"])
    if em is None:
        em = arr["active_data"][aidx]
    em = em * w_scalar

    bsdf_kind = _static_i32([s.bsdf for s in static.surfaces])
    has_diffuse = any(s.bsdf == DIFFUSE for s in static.surfaces)
    med_side = _static_i32([s.medium_side for s in static.surfaces])
    is_target = jnp.asarray([s.is_target for s in static.surfaces],
                            jnp.bool_)

    st = arr["sigma_t"]
    radon = static.mode == "radon"

    if acc is None:
        acc = jnp.zeros((static.sensor.n_cells,), jnp.float32)
    g = jnp.zeros((n,), jnp.float32)
    L_rad = jnp.zeros((n,), jnp.float32)
    sg0 = (jnp.float32(0.0), jnp.float32(0.0))

    active0 = jnp.ones((n,), jnp.bool_) if n_valid is None \
        else (lane < jnp.uint32(n_valid))

    fs = (static.first_scatter and static.scattered_only
          and static.has_scattering and static.transmission_only
          and not static.medium_grads and not radon)
    if fs:
        # every lane starts AT its forced first scatter event: the
        # pre-scatter attenuation and the event's albedo factor live in
        # A_fs (see _first_scatter_prologue), so total_t restarts at 0
        # and n_scat at 1 (deposits are live immediately).
        if "chord_L" in arr or "chord_pack" in arr:
            o, d, A_fs, inside_fs, alive_fs, ctr = \
                _first_scatter_from_chords(static, arr, o, aidx,
                                           sampler, lane, ctr)
        else:
            o, d, A_fs, inside_fs, alive_fs, ctr = \
                _first_scatter_prologue(static, arr, o, d, sampler,
                                        lane, ctr)
        active0 = active0 & alive_fs
        A0 = jnp.where(active0, A_fs, 0.0)
        if static.fast_residual and \
                static.sensor.estimator == "delta" and not radon:
            acc, g, _ = _fast_residual_loop(
                static, arr, o, d, A0, em, sampler, lane, ctr,
                active0, primal, acc, g, dL_flat)
            return acc, g, L_rad, sg0
        n_scat0 = jnp.ones((n,), jnp.float32)
        in_med0 = active0
        depth0 = jnp.ones((n,), jnp.int32)
    else:
        A0 = jnp.where(active0, 1.0, 0.0)
        n_scat0 = jnp.zeros((n,), jnp.float32)
        inside_fs = jnp.zeros((n,), jnp.bool_)
        in_med0 = jnp.zeros((n,), jnp.bool_)
        depth0 = jnp.zeros((n,), jnp.int32)

    state = dict(
        o=o, d=d, A=A0,
        total_t=jnp.zeros((n,), jnp.float32),
        n_scat=n_scat0,
        inside_target=inside_fs,
        in_medium=in_med0,
        depth=depth0,
        active=active0,
        ctr=ctr, acc=acc, g=g, L=L_rad, it=jnp.int32(0),
        stg=sg0[0], ssg=sg0[1],
    )

    max_iters = 2 * static.max_depth + 16

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_iters)

    def body(s):
        o, d, A = s["o"], s["d"], s["A"]
        active, in_medium = s["active"], s["in_medium"]
        inside_target, depth = s["inside_target"], s["depth"]
        total_t, n_scat, ctr = s["total_t"], s["n_scat"], s["ctr"]
        acc, g, L = s["acc"], s["g"], s["L"]
        sg = (s["stg"], s["ssg"])

        # Russian roulette (volume.py:181-184). The reference computes the
        # survival probability from `attenuation` which there includes the
        # analytic transmittance; reproduce that value.
        if static.has_scattering:
            rr_A = A
        else:
            rr_A = A * jnp.exp(-st * total_t)
        q = jnp.minimum(0.99, rr_A)
        perform_rr = depth > static.rr_depth
        u_rr, ctr = sampler.next_1d(lane, ctr)
        active = active & ((u_rr < q) | ~perform_rr)
        A = jnp.where(perform_rr & active, A / jnp.maximum(q, 1e-12), A)
        active = active & (A != 0.0)
        in_medium = in_medium & active

        # next surface
        t_si, n_si, sid, si_valid = intersect_scene(static, arr, o, d,
                                                    active)
        active = active & si_valid
        in_medium = in_medium & active
        hit_target = active & is_target[jnp.clip(sid, 0, None)] & (sid >= 0)

        # medium interaction sampling
        u_ff, ctr = sampler.next_1d(lane, ctr)
        if static.has_scattering and not radon:
            mei_t = sample_free_flight(u_ff, st)
            reached_surface = in_medium & (t_si < mei_t)
            mei_t = jnp.where(reached_surface, INF, mei_t)
            w_med = jnp.where(reached_surface, 1.0, 1.0 / st)
        else:
            mei_t = jnp.full((n,), INF)
            reached_surface = in_medium
            w_med = jnp.ones((n,), jnp.float32)
        medium_event = in_medium & ~reached_surface

        # ---- dose deposit along this segment -----------------------------
        dep_active = (medium_event | reached_surface) & active
        if static.scattered_only:
            # unscattered deposits belong to the ballistic matmul
            dep_active = dep_active & (n_scat > 0.0)
        if radon:
            # reference radon.py:75-77: accumulate the in-target absorption
            # with t summed over *all* path segments (incl. air/glass).
            contrib = A * jnp.exp(-st * total_t) * \
                (1.0 - jnp.exp(-st * t_si))
            L = L + jnp.where(inside_target & in_medium & active,
                              contrib, 0.0)
        elif static.sensor.estimator == "dda":
            acc, g, sg = dda_segment(static, arr, primal, acc, g,
                                     dL_flat, o, d, total_t, t_si, A,
                                     em, inside_target, dep_active,
                                     n_scat=n_scat, sg=sg)
        elif static.sensor.estimator == "ratio":
            acc, g, ctr, sg = ratio_segment(static, arr, primal, acc, g,
                                            dL_flat, o, d, total_t,
                                            t_si, A, em, inside_target,
                                            dep_active, sampler, lane,
                                            ctr, n_scat=n_scat, sg=sg)
        else:  # delta
            acc, g, sg = delta_segment(static, arr, primal, acc, g,
                                       dL_flat, o, d, total_t, mei_t, A,
                                       em, inside_target, dep_active,
                                       n_scat=n_scat, sg=sg)

        # inside/outside parity flip (volume.py:219 — may leak)
        inside_target = (~inside_target & hit_target) | \
            (inside_target & ~hit_target)

        # ---- BSDF sampling at surfaces ------------------------------------
        active_surface = active & ~medium_event
        kind = bsdf_kind[jnp.clip(sid, 0, None)]
        eta = arr["surf_eta"][jnp.clip(sid, 0, None)]
        d_t, d_r, F, tir, eta_rel = refract(d, n_si, eta)
        inv_eta2 = 1.0 / (eta_rel * eta_rel)
        u_b, ctr = sampler.next_1d(lane, ctr)
        u_ph, ctr = sampler.next_2d(lane, ctr)
        if static.transmission_only:
            w_diel = jnp.where(tir, 0.0, (1.0 - F) * inv_eta2)
            d_diel = d_t
        else:
            force_tr = depth == 0
            reflectp = (~force_tr) & (u_b < F)
            d_diel = jnp.where(reflectp[..., None], d_r, d_t)
            w_diel = jnp.where(reflectp, 1.0, inv_eta2)
            w_forced = jnp.where(tir, 0.0, (1.0 - F) * inv_eta2)
            w_diel = jnp.where(force_tr, w_forced, w_diel)

        is_diel = kind == DIELECTRIC
        is_null = kind == NULL
        w_bsdf = jnp.where(is_diel, w_diel,
                           jnp.where(is_null, 1.0, 0.0))
        d_new = jnp.where(is_diel[..., None], d_diel, d)
        if has_diffuse and not static.transmission_only:
            # diffuse occlusion surfaces (reference geometry.py:55-72):
            # cosine-hemisphere reflection on the incident side, weight
            # = reflectance (cosine-weighted importance sampling). A
            # lane is at a surface XOR a medium event, so u_ph is free
            # here. Under transmission_only (or force_tr at depth 0) a
            # diffuse lobe has no transmission component -> weight 0,
            # the w_bsdf default above.
            is_diff = (kind == DIFFUSE) & ~force_tr
            refl = arr["surf_refl"][jnp.clip(sid, 0, None)]
            nl = jnp.where(jnp.sum(d * n_si, -1)[..., None] < 0.0,
                           n_si, -n_si)
            tg, btg = _onb(nl)
            h = square_to_cosine_hemisphere(u_ph)
            d_diff = (h[..., 0:1] * tg + h[..., 1:2] * btg +
                      h[..., 2:3] * nl)
            w_bsdf = jnp.where(is_diff, refl, w_bsdf)
            d_new = jnp.where(is_diff[..., None], d_diff, d_new)

        # ---- phase sampling at medium events ------------------------------
        if static.has_scattering and not radon:
            d_scat = sample_phase_direction(
                static.phase, arr["phase_g"], d, u_ph[..., 0], u_ph[..., 1])
            # attenuation at medium events: w_med (=1/st) * sigma_s
            w_event = w_med * (st * arr["albedo"])
            n_scat = jnp.where(medium_event, n_scat + 1.0, n_scat)
        else:
            d_scat = d
            w_event = jnp.ones((n,), jnp.float32)

        # position / direction update
        seg_t = jnp.where(medium_event, mei_t, t_si)
        p_new = o + seg_t[..., None] * d
        o = jnp.where(active[..., None], p_new, o)
        d = jnp.where(medium_event[..., None], d_scat,
                      jnp.where(active_surface[..., None], d_new, d))

        # attenuation update
        w = jnp.where(medium_event, w_event,
                      jnp.where(active_surface, w_bsdf, 1.0))
        A = jnp.where(active, A * w, A)

        # path length bookkeeping: medium segments only for the volume
        # integrator (volume.py:265); *all* segments for radon, which sums
        # t over air/glass too (radon.py:78)
        if radon:
            total_t = jnp.where(active, total_t + t_si, total_t)
        else:
            total_t = jnp.where((medium_event | reached_surface) & active,
                                total_t + seg_t, total_t)

        # medium transition (volume.py:268): does the new direction enter
        # the printing medium?
        ms = med_side[jnp.clip(sid, 0, None)]
        dn = jnp.sum(d * n_si, -1)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_medium = (in_medium & ~reached_surface) | \
            (active_surface & (hit_target | enters))

        active = active & (active_surface | in_medium) & (A != 0.0)
        depth = jnp.where(active & ~hit_target, depth + 1, depth)
        active = active & (depth < static.max_depth)

        return dict(o=o, d=d, A=A, total_t=total_t, n_scat=n_scat,
                    inside_target=inside_target, in_medium=in_medium,
                    depth=depth, active=active, ctr=ctr, acc=acc, g=g,
                    L=L, it=s["it"] + 1, stg=sg[0], ssg=sg[1])

    state = jax.lax.while_loop(cond, body, state)
    return (state["acc"], state["g"], state["L"],
            (state["stg"], state["ssg"]))

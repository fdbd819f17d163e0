"""Public render entry points: chunked forward dose + custom_vjp adjoint.

This is the JAX replacement for `mi.render` dispatching to the
reference's VolumeIntegrator.render / render_backward
(integrators/volume.py:18-134) and the Dr.Jit AD tape:

  * `render_raw(static, arr, active_data, seed, spp, spp_grad, chunk)`
    returns the *unnormalized* dose accumulator (flat, n_cells) — the
    raw scatter-add target, exactly linear in `active_data`. The dose
    volume the user sees is `raw.reshape(Z,Y,X,C) * inv_vol`
    (volume.py:41-56); that multiply lives outside the custom_vjp so
    the chain rule delivers δL = upstream * inv_vol to the adjoint
    (volume.py:130).
  * The VJP re-traces the same paths with the same seed (volume.py:116)
    in Backward mode: each dose deposit *gathers* the loss-gradient
    volume instead of scattering (sensor.py:180-186), per-lane emitter
    gradients are segment-summed into per-active-pixel pattern
    gradients (volume.py:274-276). The backward wavefront uses
    `spp_grad` samples (optimize.py:294 `spp_grad=`), an independent
    unbiased gradient estimate.
  * Wavefronts larger than `chunk` lanes are processed in multiple
    passes accumulating into the same dose grid — the reference instead
    hard-errors at 2^32 lanes (common.py:60-65).

Also here: the forward-only Radon and corner filter renders used for
DMD pixel culling (integrators/radon.py, integrators/filter_corner.py).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .march import MarchStatic, trace_wavefront, intersect_scene
from ..core.rng import Sampler
from ..models.projector import sample_rays, ray_weight

# Default lanes per pass: sized so the live wavefront state (~30 f32s
# per lane) stays well under device memory alongside the dose grid.
DEFAULT_CHUNK_ACCEL = 1 << 20
DEFAULT_CHUNK_CPU = 1 << 16


def default_chunk():
    """Lanes per pass for the platform JAX runs on."""
    if jax.devices()[0].platform == "cpu":
        return DEFAULT_CHUNK_CPU
    return DEFAULT_CHUNK_ACCEL


def _chunking(n_lanes, chunk, spp=1):
    # pixel-aligned chunks: all spp lanes of a pixel land in the same
    # chunk, so per-chunk emitter values / pattern gradients are plain
    # dynamic slices of active_data (no 64M-table gather / scatter)
    chunk = max(spp, min(chunk, n_lanes))
    chunk -= chunk % spp
    return chunk, -(-n_lanes // chunk)


def _forward(static: MarchStatic, arr, active_data, seed, spp, chunk):
    n_active = static.projector.n_active
    n_lanes = n_active * spp
    chunk, n_chunks = _chunking(n_lanes, chunk, spp)
    npix = chunk // spp
    arr2 = dict(arr)
    arr2["active_data"] = active_data
    # zero-padded copy so the last chunk's slice is in range (padding
    # lanes are masked dead via n_valid)
    ad_pad = jnp.zeros((n_chunks * npix,), jnp.float32) \
        .at[:n_active].set(active_data) if n_chunks * npix > n_active \
        else active_data
    acc0 = jnp.zeros((static.sensor.n_cells,), jnp.float32)
    lane_base = jnp.arange(chunk, dtype=jnp.uint32)

    def body(i, acc):
        lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk)
        em = jnp.repeat(jax.lax.dynamic_slice(ad_pad, (i * npix,),
                                              (npix,)), spp)
        acc, _, _, _ = trace_wavefront(static, arr2, lane, seed, spp,
                                       acc=acc, n_valid=n_lanes, em=em)
        return acc

    if n_chunks == 1:
        return body(0, acc0)
    return jax.lax.fori_loop(0, n_chunks, body, acc0)


def _adjoint(static: MarchStatic, arr, seed, spp, chunk, dL_flat,
             active_data=None):
    n_active = static.projector.n_active
    n_lanes = n_active * spp
    chunk, n_chunks = _chunking(n_lanes, chunk, spp)
    npix = chunk // spp
    n_pad = n_chunks * npix
    arr2 = dict(arr)
    # em never contributes to adjoint PATTERN deposits (march.py uses 1
    # in place of em when primal=False), but the medium cotangents need
    # the real emitted intensities (reference sensor.py contrib has em
    # detached-but-present). Zeros keep the trace identical otherwise.
    want_em = active_data is not None and static.medium_grads
    if want_em:
        arr2["active_data"] = active_data
        ad_pad = jnp.zeros((n_pad,), jnp.float32) \
            .at[:n_active].set(active_data) if n_pad > n_active \
            else active_data
    else:
        arr2["active_data"] = jnp.zeros((n_active,), jnp.float32)
    lane_base = jnp.arange(chunk, dtype=jnp.uint32)
    pg0 = jnp.zeros((n_pad,), jnp.float32)
    sg0 = (jnp.float32(0.0), jnp.float32(0.0))

    def body(i, carry):
        pg, stg, ssg = carry
        lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk)
        em = jnp.repeat(jax.lax.dynamic_slice(ad_pad, (i * npix,),
                                              (npix,)), spp) \
            if want_em else jnp.zeros((chunk,), jnp.float32)
        _, g, _, sg = trace_wavefront(static, arr2, lane, seed, spp,
                                      dL_flat=dL_flat, n_valid=n_lanes,
                                      em=em)
        # lanes are pixel-contiguous: the per-pixel gradient block is a
        # reshape-sum + dynamic-update-slice, not a 64M scatter-add
        g_pix = g.reshape(npix, spp).sum(axis=1)
        blk = jax.lax.dynamic_slice(pg, (i * npix,), (npix,))
        pg = jax.lax.dynamic_update_slice(pg, blk + g_pix, (i * npix,))
        return (pg, stg + sg[0], ssg + sg[1])

    carry = body(0, (pg0,) + sg0) if n_chunks == 1 else \
        jax.lax.fori_loop(0, n_chunks, body, (pg0,) + sg0)
    pg, stg, ssg = carry
    w = ray_weight(static.projector, arr, spp, arr["print_time"])
    return pg[:n_active] * w, stg, ssg


@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5, 6))
def render_raw(static: MarchStatic, arr, active_data, seed, spp,
               spp_grad, chunk):
    """Flat unnormalized dose accumulator (n_cells,), linear in
    active_data. seed must be a jnp uint32 scalar (traced — changing the
    per-iteration seed does not retrigger compilation)."""
    return _forward(static, arr, active_data, seed, spp, chunk)


def _render_raw_fwd(static, arr, active_data, seed, spp, spp_grad, chunk):
    acc = _forward(static, arr, active_data, seed, spp, chunk)
    return acc, (arr, active_data, seed)


def _zero_ct(x):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


def _render_raw_bwd(static, spp, spp_grad, chunk, res, ct):
    arr, active_data, seed = res
    pg, stg, ssg = _adjoint(static, arr, seed, spp_grad, chunk, ct,
                            active_data=active_data)
    arr_ct = {k: _zero_ct(v) for k, v in arr.items()}
    if static.medium_grads:
        # the march accumulates partials w.r.t. the (sigma_t, sigma_s)
        # leaves; our medium is parameterized (sigma_t, albedo) with
        # sigma_s = albedo * sigma_t — chain rule:
        albedo = jnp.asarray(arr["albedo"], jnp.float32)
        sigma_t = jnp.asarray(arr["sigma_t"], jnp.float32)
        arr_ct["sigma_t"] = (stg + albedo * ssg).astype(jnp.float32)
        arr_ct["albedo"] = (sigma_t * ssg).astype(jnp.float32)
    seed_ct = np.zeros(jnp.shape(seed), jax.dtypes.float0)
    return (arr_ct, pg, seed_ct)


render_raw.defvjp(_render_raw_fwd, _render_raw_bwd)


def render(static: MarchStatic, arr, active_data, inv_vol, seed=0, spp=1,
           spp_grad=None, chunk=None):
    """Dose volume (Z, Y, X, C): raw accumulator x 1/voxel-volume
    (volume.py:41-56). Differentiable w.r.t. active_data through the
    custom adjoint."""
    if spp_grad is None:
        spp_grad = spp
    if chunk is None:
        chunk = default_chunk()
    seed = jnp.asarray(seed, jnp.uint32)
    raw = render_raw(static, arr, active_data, seed, spp, spp_grad, chunk)
    return raw.reshape(static.sensor.shape) * inv_vol


def render_radon(static: MarchStatic, arr, seed=0, spp=4, chunk=None):
    """Forward-only Radon render: per-DMD-pixel accumulated in-target
    absorption, scattered to the dense (n_patterns*resy*resx,) image
    array (integrators/radon.py:41-44). Used for `filter_radon` culling."""
    assert static.mode == "radon"
    arr = {k: jnp.asarray(v) for k, v in arr.items()}
    if chunk is None:
        chunk = default_chunk()
    seed = jnp.asarray(seed, jnp.uint32)
    p = static.projector
    n_lanes = p.n_active * spp
    chunk, n_chunks = _chunking(n_lanes, chunk)
    arr2 = dict(arr)
    arr2["active_data"] = jnp.zeros((p.n_active,), jnp.float32)
    w = ray_weight(p, arr, spp, arr["print_time"])
    n_dense = p.n_patterns * p.resy * p.resx
    lane_base = jnp.arange(chunk, dtype=jnp.uint32)
    img0 = jnp.zeros((n_dense,), jnp.float32)

    def body(i, img):
        lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk)
        _, _, L, _ = trace_wavefront(static, arr2, lane, seed, spp,
                                     n_valid=n_lanes)
        aidx = jnp.minimum(lane // jnp.uint32(spp),
                           jnp.uint32(p.n_active - 1)).astype(jnp.int32)
        pix = arr["active_pixels"][aidx]
        return img.at[pix].add(L * w)

    if n_chunks == 1:
        return body(0, img0)
    return jax.lax.fori_loop(0, n_chunks, body, img0)


def render_corner(static: MarchStatic, arr, dist, radius=0.1, seed=0,
                  chunk=None):
    """Corner-filter render (integrators/filter_corner.py): one bounce,
    a pixel survives unless its first hit lies within `radius` of a
    square-vial corner at distance `dist` from the axis. Returns the
    dense per-pixel keep image (>0 = keep). Uses regular sampling and
    spp=1 like the reference config (optimize.py:166-171)."""
    # device arrays throughout: intersect_scene's grid traversal runs a
    # lax.while_loop, and numpy closure constants indexed by its traced
    # cell ids raise TracerArrayConversionError
    arr = {k: jnp.asarray(v) for k, v in arr.items()}
    if chunk is None:
        chunk = default_chunk()
    seed = jnp.asarray(seed, jnp.uint32)
    p = static.projector
    spp = 1
    n_lanes = p.n_active
    chunk, n_chunks = _chunking(n_lanes, chunk)
    sampler = Sampler(seed)
    w = ray_weight(p, arr, spp, arr["print_time"])
    n_dense = p.n_patterns * p.resy * p.resx
    lane_base = jnp.arange(chunk, dtype=jnp.uint32)
    img0 = jnp.zeros((n_dense,), jnp.float32)

    def body(i, img):
        lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk)
        ctr = sampler.init(lane.shape[0])
        o, d, aidx, ctr = sample_rays(
            p, arr, arr["active_pixels"], lane, spp, sampler, ctr,
            True, False, static.clockwise)
        valid = lane < jnp.uint32(n_lanes)
        t, n, sid, hit = intersect_scene(static, arr, o, d, valid)
        pos = o + t[..., None] * d
        corner_d = jnp.linalg.norm(jnp.abs(pos[..., :2]) - dist, axis=-1)
        keep = hit & (corner_d >= radius)
        val = jnp.where(keep & valid, 1.0, 0.0) * w
        pix = arr["active_pixels"][jnp.minimum(
            aidx, p.n_active - 1)]
        return img.at[pix].add(val)

    if n_chunks == 1:
        return body(0, img0)
    return jax.lax.fori_loop(0, n_chunks, body, img0)

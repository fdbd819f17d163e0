"""Hybrid scattering engine: analytic unscattered transport
(backprojection) + Monte-Carlo scattered residual (wavefront march).

The reference renders scattering scenes by brute-force analog path
tracing with per-segment dose deposits (integrators/volume.py:199-263,
16 rays/pixel in its published benchmarks, README.md:133-135). The
deposits of the *unscattered* path prefix — the overwhelming
majority of all scatter-writes — have a closed form: for z-invariant
geometry the expected n_scat == 0 deposit of every reference estimator
(dda exactly, ratio/delta in expectation — sensor.py:121-440) is the
analytic per-voxel Beer-Lambert absorption along the deterministic
refracted polyline, which ops/transport2d.py precomputes once per
scene and ops/backproject.py applies as a two-tap backprojection.

This engine therefore decomposes

    dose = E[unscattered deposits]  (deterministic, backprojection)
         + MC[deposits with n_scat >= 1]  (wavefront march in
           `scattered_only` mode: identical analog paths, n_scat == 0
           deposits suppressed)

which is an unbiased estimate of the reference's scattering render
with *strictly lower variance* at equal rays/pixel: the dominant dose
component carries zero MC noise. The scattered residual defaults to
the scene's configured estimator; `delta` costs one scatter-write per
medium event (vs one per voxel crossed for dda) and is the cheaper
choice.

Both components are exactly linear in the pattern vector, so the
LinearLBFGS direction-render trick (lbfgs.py:248) applies unchanged,
and both are differentiable (backproject custom_vjp + render_raw
custom_vjp with seed replay), so `jax.grad` through `render_vol`
yields the exact pattern gradient.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

import jax

from .ballistic import BallisticEngine
from .transport2d import unscattered_eligible, strip_target, build_chords
from .render import render, default_chunk, _adjoint
from .march import MarchStatic, fast_residual_eligible

_build_chords = jax.jit(build_chords, static_argnums=(0, 2))

__all__ = ["ScatteringEngine", "hybrid_eligible"]


def hybrid_eligible(static: MarchStatic) -> bool:
    """Scattering scene whose unscattered transport is precomputable."""
    return static.has_scattering and unscattered_eligible(static)


class ScatteringEngine:
    """Per-(scene, sensor) engine for scattering media.

    `render_vol(active_data, inv_vol, seed)` returns the (Z, Y, X, C)
    dose volume, differentiable w.r.t. active_data. The seed drives the
    scattered-residual wavefront; vary it per optimization step like
    the reference's per-iteration sampler seed (optimize.py:294).

    estimator: override the dose estimator used for the scattered
    residual only ('dda' | 'ratio' | 'delta'); None keeps the scene's
    configured sensor estimator.

    first_scatter: importance-sample every residual lane's first
    scatter event along its deterministic in-medium chord (see
    march.MarchStatic.first_scatter) instead of tracing the analog
    prefix — same expectation, ~1/P_scat lower variance per lane, and
    no wasted never-scattering lanes (at the reference benchmark's
    albedo 0.5 / tau~1 only ~19% of analog lanes deposit anything).
    """

    def __init__(self, static: MarchStatic, arr, spp: int = 4,
                 spp_grad: int | None = None, chunk: int | None = None,
                 inside_mask=None, estimator: str | None = None,
                 first_scatter: bool = True,
                 residual_max_depth: int | None = None):
        """residual_max_depth: depth cap for the scattered residual
        only (None keeps the scene's max_depth). The reference counts
        SURFACE events toward max_depth (volume.py:271), so with its
        default cap of 6 a vial path that crossed 2-3 dielectric
        interfaces gets only ~2 medium events after its first scatter;
        our residual lanes skip the surface prefix entirely, so the
        scene cap would grant them max_depth-1 events — strictly more
        than the reference estimator traces. Passing a reduced cap
        (e.g. 4 = forced first scatter + 3 more events) restores the
        reference-equivalent event budget and cuts the deposit-flush
        traffic."""
        assert hybrid_eligible(static), \
            "scene is not hybrid-eligible (needs scattering + " \
            "z-invariant collimated geometry)"
        self.ball = BallisticEngine(static, arr, inside_mask=inside_mask,
                                    unscattered=True)
        sensor = static.sensor
        if estimator is not None and estimator != sensor.estimator:
            sensor = dataclasses.replace(sensor, estimator=estimator)
        if first_scatter:
            arr = dict(arr)
            # chord bank: the prologue's geometric march collapses to a
            # per-(angle, column) lookup for z-invariant geometry (the
            # same factorization the ballistic transport fields use)
            import os
            import time
            import numpy as np
            t0 = time.perf_counter()
            st2, arr2 = strip_target(static, arr)
            # the bank is small (A*U lanes) and geometry-only: one
            # jitted trace on the default device, read back once; the
            # per-pixel pattern store stays behind
            geom = {k: v for k, v in arr2.items()
                    if k not in ("active_data", "active_pixels")}
            bank = [np.asarray(b) for b in _build_chords(st2, geom)]
            if os.environ.get("DRTVAM_BUILD_LOG") == "1":
                import sys
                print(f"#   engine build: chord bank: "
                      f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            co, cd, cL, camp = bank
            # packed (n_cid, 12) record table: the march gathers ONE
            # record per lane instead of four separate field gathers
            n_cid = cL.shape[0]
            arr["chord_pack"] = np.concatenate(
                [co.reshape(n_cid, 4), cd.reshape(n_cid, 4),
                 cL, camp], axis=1).astype(np.float32)
            if static.sensor.channels == 2:
                # the prologue seeds the surface-aware channel flag from
                # the voxelized inside-mask at the sampled event point
                arr["inside_mask_flat"] = \
                    jnp.asarray(inside_mask, jnp.float32).reshape(-1)
        self.static_s = dataclasses.replace(
            static, scattered_only=True, sensor=sensor,
            first_scatter=first_scatter,
            max_depth=(static.max_depth if residual_max_depth is None
                       else residual_max_depth),
            fast_residual=(first_scatter
                           and sensor.estimator == "delta"
                           and fast_residual_eligible(static)))
        self.spp = spp
        self.spp_grad = spp if spp_grad is None else spp_grad
        self.chunk = default_chunk() if chunk is None else chunk
        self._arr = arr

    def params(self):
        """Device-array pytree to pass through jitted step functions
        (same contract as BallisticEngine.params)."""
        return {"ball": self.ball.params(),
                "arr": {k: jnp.asarray(v) for k, v in self._arr.items()}}

    def render_vol(self, active_data, inv_vol, seed=0, params=None,
                   spp=None):
        """spp overrides the residual rays/pixel for THIS call only —
        e.g. a high-quality final render (the reference's spp_ref
        convention, optimize.py:231-238) without rebuilding the engine
        (the ballistic transport fields are spp-independent)."""
        p = self.params() if params is None else params
        spp = self.spp if spp is None else spp
        vol_b = self.ball.render_vol(active_data, inv_vol,
                                     params=p["ball"])
        vol_s = render(self.static_s, p["arr"], active_data, inv_vol,
                       seed=seed, spp=spp, spp_grad=self.spp_grad,
                       chunk=self.chunk)
        return vol_b + vol_s

    def pattern_grad(self, dvol, inv_vol, seed=0, params=None):
        """d loss / d active_data given d loss / d vol — the explicit
        adjoint (avoids re-running the forward inside a vjp): ballistic
        transpose matmuls + one scattered-residual adjoint wavefront
        with the SAME seed (path replay, reference volume.py:116)."""
        p = self.params() if params is None else params
        gb = self.ball.pattern_grad(dvol, inv_vol, params=p["ball"])
        dL_flat = (dvol * inv_vol).reshape(-1)
        seed = jnp.asarray(seed, jnp.uint32)
        gs, _, _ = _adjoint(self.static_s, p["arr"], seed, self.spp_grad,
                            self.chunk, dL_flat)
        return gb + gs

"""Ballistic fast-path engine: transport-field precompute + two-tap
backprojection, with the exact adjoint for pattern gradients.

Glues transport2d (geometry precompute, once per scene) to backproject
(per-render gathers). Numerically this reproduces the reference's
non-scattering DDA volume integrator with regular (pixel-center)
sampling — deterministic, zero-variance where the MC reference has
jitter noise — as a gather per cell and angle instead of per-voxel
scatter atomics.

Surface-aware films (2 channels, film.py:16-21): the target mesh has a
null BSDF and never deflects rays; the reference flips the deposit
channel at each target crossing (volume.py:219). Here the channel is
selected per voxel by the voxelized inside-mask — dose_in = M * dose,
dose_out = (1-M) * dose — a pure elementwise split outside the kernels,
so both channels cost one backprojection.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .transport2d import build_transport, build_z_resample, \
    ballistic_eligible, unscattered_eligible, strip_target
from .backproject import backproject, adjoint, default_impl, prepare
from .march import MarchStatic

__all__ = ["BallisticEngine", "ballistic_eligible"]


def _now():
    import time
    return time.perf_counter()


def _build_log(stage, detail, t0):
    import sys
    d = f" [{detail}]" if detail else ""
    print(f"#   engine build: {stage}{d}: {_now() - t0:.2f}s",
          file=sys.stderr)


# module-level jit so repeated engine construction for the same geometry
# shape hits the compile cache
_build_transport = jax.jit(build_transport, static_argnums=(0, 2))


class BallisticEngine:
    """Per-(scene, sensor) engine. Construction traces + rasterizes the
    2D ray fan (one-time, seconds); `render_vol` / `pattern_grad` are
    pure jittable functions of the sparse pattern vector.

    For surface-aware sensors pass `inside_mask` — the (Z, Y, X) binary
    occupancy of the target in this sensor's grid."""

    def __init__(self, static: MarchStatic, arr, supersample: int = 1,
                 impl: str | None = None, inside_mask=None,
                 unscattered: bool = False):
        """unscattered=True builds the engine as the *unscattered
        transport* of a scattering scene (the first-flight component of
        the hybrid engine, ops/hybrid.py) — geometry eligibility only,
        the estimator/scattering checks don't apply."""
        if unscattered:
            assert unscattered_eligible(static), \
                "scene geometry not precomputable as 2D transport fields"
        else:
            assert ballistic_eligible(static), "scene not ballistic-eligible"
        self.static = static
        self.impl = impl or default_impl()
        self.surface_aware = static.sensor.channels == 2
        if self.surface_aware:
            assert inside_mask is not None, \
                "surface-aware ballistic engine needs the inside mask"
            self.mask = jnp.asarray(inside_mask).reshape(
                static.sensor.res[2], static.sensor.res[1],
                static.sensor.res[0])
        else:
            self.mask = None
        static2, arr2 = strip_target(static, arr)
        # transport precompute: two equivalent paths (identical math,
        # tested equivalent). Preferred everywhere: the native C++
        # rasterizer (OpenMP host, the Mitsuba-scene-build analog) — no
        # jit compile, and its sequential DDA walks run at host speed.
        # DRTVAM_NATIVE_TRANSPORT: auto (default: native when
        # buildable) | 1 force native | 0 force the device builder.
        choice = os.environ.get("DRTVAM_NATIVE_TRANSPORT", "auto")
        # DRTVAM_BUILD_LOG=1: stderr breadcrumbs timing each build stage
        log = _build_log if os.environ.get("DRTVAM_BUILD_LOG") == "1" \
            else (lambda *_: None)
        t0 = _now()
        native = None
        if choice != "0":
            from ..native import build_transport_native
            native = build_transport_native(static2, arr2, supersample)
        self.transport_builder = "native C++" if native is not None \
            else "jitted device"
        log("transport builder", self.transport_builder, t0)
        t0 = _now()
        if native is not None:
            # host numpy end to end: Umap derived on host, then one f32
            # upload per field
            Wn, UWn = native
            with np.errstate(divide="ignore", invalid="ignore"):
                Un = np.where(Wn > 0, UWn / np.maximum(Wn, 1e-30),
                              np.float32(-2.0)).astype(np.float32)
            W, Umap = jnp.asarray(Wn), jnp.asarray(Un)
        else:
            # ship ONLY the fields the 2D trace reads: the full dict
            # carries the 64M-entry pattern store, which the transport
            # never touches
            keys = ("surf_params", "surf_eta", "bbox_min", "bbox_max",
                    "sigma_t", "albedo", "pixel_size", "motion_distance")
            arr_small = {k: arr2[k] for k in keys}
            W, UW = _build_transport(static2, arr_small, supersample)
            Umap = jnp.where(W > 0, UW / jnp.maximum(W, 1e-30), -2.0)
        self.geo = prepare(self.impl, W, Umap, static.projector.resx)
        jax.block_until_ready(self.geo)
        log(f"upload + {self.impl} operands", "", t0)
        t0 = _now()
        Szn = np.asarray(build_z_resample(static, arr))
        self._build_z_taps(Szn)
        log("z-resample + taps (host)", "", t0)
        t0 = _now()
        if self.z_taps is None:
            # dense fallback only — the K-tap path never touches Sz
            self.Sz = jnp.asarray(Szn)
            log("Sz upload", "", t0)
            t0 = _now()
        else:
            self.Sz = Szn
        p = static.projector
        # ray weight: pixel_area * print_time, spp=1 (projector.py:184-188
        # + common.py:111); the dose stays "raw" — inv_vol applied by the
        # caller exactly like ops.render.render.
        self.scalar = jnp.float32(float(np.asarray(arr["pixel_size"])[0]) *
                                  float(np.asarray(arr["pixel_size"])[1]) *
                                  float(np.asarray(arr["print_time"])))
        self.active_pixels = arr["active_pixels"]
        self.n_active = p.n_active
        self.shape_dense = (p.n_patterns, p.resy, p.resx)
        # With every pixel active (no radon/corner culling) the sparse
        # store is the identity: detect it once and reshape instead of
        # lowering to a 64M-lane scatter/gather.
        n_dense = p.n_patterns * p.resy * p.resx
        ap = self.active_pixels
        if ap.shape[0] != n_dense:
            self._identity_pixels = False
        elif isinstance(ap, np.ndarray):
            self._identity_pixels = bool(ap[0] == 0
                                         and np.all(np.diff(ap) == 1))
        else:
            # device array of full dense size: defer the (blocking)
            # device-side check until the first params()/render call so
            # engine construction never syncs
            self._identity_pixels = None
        if isinstance(ap, np.ndarray) and not self._identity_pixels:
            # non-identity sparse maps are gathered per render: keep
            # them device-resident instead of re-uploading per call
            self.active_pixels = jnp.asarray(ap)
        # parallel.shard.shard_ballistic_engine replaces this with an
        # angle-sharded mesh implementation
        self._sharded_bp = None

    @property
    def identity_pixels(self):
        if self._identity_pixels is None:
            ap = self.active_pixels
            # one blocking sync, once, at first use (not construction)
            self._identity_pixels = bool(jnp.all(jnp.diff(ap) == 1)
                                         and ap[0] == 0)
        return self._identity_pixels

    # -- z-resample as K-tap gathers ---------------------------------------

    _MAX_TAPS = 4

    def _build_z_taps(self, Szn):
        """The (Zf, resy) binning matrix has <= ~3 nonzeros per row and
        per column (a DMD row feeds the voxels its z-footprint overlaps,
        build_z_resample). Contracting it densely costs
        2*A*Zf*resy*U FLOPs per render — comparable to the
        backprojection itself — so precompute fixed-K tap tables and
        lower both directions to K weighted `take`s instead.
        """
        Z, R = Szn.shape
        K = self._MAX_TAPS
        if (np.count_nonzero(Szn, axis=1).max() > K or
                np.count_nonzero(Szn, axis=0).max() > K):
            self.z_taps = None
            return
        zt_i = np.zeros((Z, K), np.int32)
        zt_w = np.zeros((Z, K), np.float32)
        for z in range(Z):
            nz = np.nonzero(Szn[z])[0]
            zt_i[z, :nz.size] = nz
            zt_w[z, :nz.size] = Szn[z, nz]
        rt_i = np.zeros((R, K), np.int32)
        rt_w = np.zeros((R, K), np.float32)
        for r in range(R):
            nz = np.nonzero(Szn[:, r])[0]
            rt_i[r, :nz.size] = nz
            rt_w[r, :nz.size] = Szn[nz, r]
        self.z_taps = (jnp.asarray(zt_i), jnp.asarray(zt_w),
                       jnp.asarray(rt_i), jnp.asarray(rt_w))

    @staticmethod
    def _tap_contract(x, idx, w):
        """sum_k w[:, k] * x[:, idx[:, k], :] along the middle axis."""
        out = None
        for k in range(idx.shape[1]):
            term = jnp.take(x, idx[:, k], axis=1) * w[None, :, k, None]
            out = term if out is None else out + term
        return out

    def _resample_fwd(self, P, p):
        """(A, resy, U) patterns -> (A, Zf, U), == einsum('zr,aru->azu')."""
        if "zt_i" in p:
            return self._tap_contract(P, p["zt_i"], p["zt_w"])
        return jnp.einsum("zr,aru->azu", p["Sz"], P,
                          precision=jax.lax.Precision.HIGHEST)

    def _resample_bwd(self, Pz_bar, p):
        """(A, Zf, U) -> (A, resy, U), == einsum('zr,azu->aru')."""
        if "rt_i" in p:
            return self._tap_contract(Pz_bar, p["rt_i"], p["rt_w"])
        return jnp.einsum("zr,azu->aru", p["Sz"], Pz_bar,
                          precision=jax.lax.Precision.HIGHEST)

    # -- differentiable forward -------------------------------------------

    def params(self):
        """Device-array fields as a pytree. Pass this as an ARGUMENT to
        your jitted step functions (and hand it to render_vol /
        pattern_grad via `params=`) instead of letting jit capture the
        fields as closure constants — W/Umap are O(angles x film^2) and
        constant-folding them bloats the compiled executable."""
        ap = self.active_pixels
        if self.identity_pixels:
            # dense identity store: the index map is never gathered;
            # don't ship 64M indices through every dispatch
            ap = jnp.zeros((0,), jnp.int32)
        p = {"geo": self.geo, "scalar": self.scalar, "active_pixels": ap}
        if self.z_taps is not None:
            p["zt_i"], p["zt_w"], p["rt_i"], p["rt_w"] = self.z_taps
        else:
            p["Sz"] = self.Sz
        if self.surface_aware:
            p["mask"] = self.mask
        return p

    def dense_patterns(self, active_data, active_pixels=None):
        ap = self.active_pixels if active_pixels is None else active_pixels
        n, ry, rx = self.shape_dense
        if self.identity_pixels:
            return active_data.reshape(n, ry, rx)
        flat = jnp.zeros((n * ry * rx,), jnp.float32)
        flat = flat.at[ap].set(active_data)
        return flat.reshape(n, ry, rx)

    def render_vol(self, active_data, inv_vol, params=None):
        """(Z, Y, X, C) dose volume; differentiable w.r.t. active_data."""
        p = self.params() if params is None else params
        P = self.dense_patterns(active_data, p["active_pixels"])
        Pz = self._resample_fwd(P, p)
        if self._sharded_bp is not None:
            dose = self._sharded_bp(Pz, p["geo"])
        else:
            dose = backproject(self.impl, Pz, p["geo"])
        X, Y, Z = self.static.sensor.res
        dose = dose.reshape(Z, Y, X) * p["scalar"]
        if self.surface_aware:
            vol = jnp.stack([dose * p["mask"],
                             dose * (1.0 - p["mask"])], axis=-1)
        else:
            vol = dose[..., None]
        return vol * inv_vol

    # -- explicit adjoint (avoids re-running the forward inside vjp) ------

    def pattern_grad(self, dvol, inv_vol, params=None):
        """d loss / d active_data given d loss / d vol."""
        p = self.params() if params is None else params
        X, Y, Z = self.static.sensor.res
        U = self.shape_dense[2]
        dvol = dvol * inv_vol
        if self.surface_aware:
            dL = dvol[..., 0] * p["mask"] + dvol[..., 1] * \
                (1.0 - p["mask"])
        else:
            dL = dvol[..., 0]
        dL = (dL * p["scalar"]).reshape(Z, Y * X)
        if self._sharded_bp is not None:
            # device-local per-angle adjoint, no collective
            Pz_bar = self._sharded_bwd(dL, p["geo"])
        else:
            Pz_bar = adjoint(self.impl, dL, p["geo"], U)
        Pbar = self._resample_bwd(Pz_bar, p)
        if self.identity_pixels:
            return Pbar.reshape(-1)
        return Pbar.reshape(-1)[p["active_pixels"]]


def radon_active_ballistic(static: MarchStatic, arr, target_mask):
    """Analytic Radon culling for transport-eligible scenes.

    The reference deactivates DMD pixels whose Radon-transform render is
    zero (optimize.py:143-163); its radon integrator accumulates the
    in-target Beer-Lambert absorption along the refracted, NON-scattered
    path (radon.py:69-106) — exactly the support of the unscattered
    transport field W. One adjoint backprojection of the binary target
    occupancy therefore yields the same kept-pixel set as a wavefront
    radon render, in milliseconds instead of a 10^8-lane march.

    target_mask: (Z, Y, X) or (Z, Y, X, 1) binary target occupancy in
    the SENSOR grid. Returns int32 indices of the DMD pixels to keep,
    always in DENSE flat (pattern, row, col) numbering — when the
    projector already has a sparse active set (cropped windows, or
    patterns + filter_nonzero), pattern_grad's output is active-subset-
    relative and is mapped back through the sparse store here, because
    every caller (Projector.set_active, the legacy radon render path)
    speaks dense flat DMD indices.
    """
    import dataclasses as _dc
    st1 = _dc.replace(static, sensor=_dc.replace(static.sensor,
                                                 surface_aware=False))
    eng = BallisticEngine(st1, arr, unscattered=True)
    X, Y, Z = st1.sensor.res
    mask = jnp.asarray(target_mask, jnp.float32).reshape(Z, Y, X, 1)
    g = np.asarray(eng.pattern_grad(mask, jnp.float32(1.0)))
    idx = np.nonzero(g > 0.0)[0]
    if not eng.identity_pixels:
        idx = np.asarray(eng.active_pixels)[idx]
    return idx.astype(np.int32)

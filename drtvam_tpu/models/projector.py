"""DMD projectors: sparse pattern storage + per-lane ray generation.

Replaces the reference's TVAMProjector emitter family
(drtvam/projector.py): patterns live as a sparse pair
(active_data float values, active_pixels flat indices into the dense
(n_patterns, resy, resx) tensor), with crop-window support. Ray
generation follows integrators/common.py:70-116: lane -> (pattern idx,
pixel row/col) -> jittered position in [0,1]^2 -> camera-space ray by
projection model -> world via the motion transform at
time = pattern_idx / n_patterns.

Camera convention matches Mitsuba's orthographic/perspective projections
as the reference uses them: sample (sx, sy) in [0,1]^2 maps to camera
x = (0.5 - sx) * width, y = (0.5 - sy) * height, rays along +z_cam
(which look_at points at the vial).
"""
from __future__ import annotations

import os
import glob
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .motion import motions, CircularMotion
from ..core.warp import square_to_uniform_disk_concentric
from ..core.transforms import apply_rt_point, apply_rt_vector


def load_patterns(filepath):
    """Load a (n, h, w) pattern stack from .npy / single-array .npz /
    a directory of EXR images (reference projector.py:8-39)."""
    if os.path.isfile(filepath):
        if filepath.endswith(".npy"):
            return np.load(filepath).astype(np.float32)
        if filepath.endswith(".npz"):
            z = np.load(filepath)
            if len(z.files) != 1:
                raise ValueError(
                    f"Expected a single array in the npz file, got "
                    f"{len(z.files)}.")
            return z[z.files[0]].astype(np.float32)
        raise ValueError(
            f"Unsupported file format for patterns: "
            f"{os.path.splitext(filepath)[1]}")
    filenames = sorted(glob.glob(os.path.join(filepath, "*.exr")))
    if not filenames:
        raise ValueError("No patterns found in the specified directory. "
                         "Please make sure the patterns are in EXR format.")
    from ..utils.io import read_exr
    imgs = [read_exr(fn) for fn in filenames]
    h, w = imgs[0].shape[:2]
    for fn, im in zip(filenames, imgs):
        if im.shape[:2] != (h, w):
            raise ValueError(f"File '{fn}' has a different resolution.")
    return np.stack([im[..., 0] if im.ndim == 3 else im for im in imgs])


@dataclass(frozen=True)
class ProjectorStatic:
    """Hashable projector config baked into the jitted render."""
    kind: str                 # 'collimated' | 'telecentric' | 'lens'
    n_patterns: int
    resx: int
    resy: int
    n_active: int
    # sparse pattern store is the dense identity map (no culling/crop):
    # ray generation then derives pixel ids arithmetically instead of
    # gathering active_pixels — at 64M lanes that random-access gather
    # is a large share of the wavefront's work
    identity: bool = False


class Projector:
    """Host-side projector state; produces (static, arrays) for the
    renderer and owns the motion model."""

    def __init__(self, props, resolve_path=lambda p: p):
        kind = props["type"]
        if kind not in ("collimated", "telecentric", "lens"):
            raise ValueError(f"Unknown projector type: '{kind}'")
        self.kind = kind

        if "patterns" in props:
            pat = props["patterns"]
            if isinstance(pat, str):
                pat = load_patterns(resolve_path(pat))
            pat = np.asarray(pat, np.float32)
            if pat.ndim != 3:
                raise ValueError(
                    f"Patterns must be 3D, got shape {pat.shape}.")
            n, h, w = pat.shape
            self.n_patterns, self.resy, self.resx = n, h, w
            self.crop = (w, h)
            self.crop_offset = (0, 0)
            # host numpy storage: device transfer happens once, when
            # these ride into a jitted call as arguments — eager device
            # ops here would cost host<->device round trips per scene
            if props.get("filter_nonzero", False):
                flat = pat.reshape(-1)
                idx = np.nonzero(flat > 0)[0].astype(np.int32)
                self.active_pixels = idx
                self.active_data = flat[idx]
                self.dense_identity = False
            else:
                self.active_data = pat.reshape(-1)
                self.active_pixels = np.arange(n * h * w, dtype=np.int32)
                self.dense_identity = True
        else:
            self.n_patterns = int(props.get("n_patterns", 1000))
            self.resx = int(props.get("resx", 256))
            self.resy = int(props.get("resy", 256))
            cropx = int(props.get("cropx", self.resx))
            cropy = int(props.get("cropy", self.resy))
            if cropx > self.resx or cropy > self.resy:
                raise ValueError("Crop resolution must be smaller than the "
                                 "base resolution.")
            ox = int(props.get("crop_offset_x", 0))
            oy = int(props.get("crop_offset_y", 0))
            if ox + cropx > self.resx or oy + cropy > self.resy:
                raise ValueError("Cropped region extends beyond the base "
                                 "resolution.")
            self.crop = (cropx, cropy)
            self.crop_offset = (ox, oy)
            # every pixel of every pattern active, in order: the sparse
            # store is the identity map (fast paths skip the scatter)
            self.dense_identity = (cropx == self.resx and
                                   cropy == self.resy)
            if self.dense_identity:
                # identity map: a plain arange, no index arithmetic
                # (building 64M-entry int64 products costs tens of
                # seconds of first-touch allocation on small hosts)
                flat = np.arange(self.n_patterns * self.resx * self.resy,
                                 dtype=np.int32)
            else:
                # flat indices of the cropped window, tiled per pattern
                ci = np.arange(cropx * cropy, dtype=np.int32)
                crow, ccol = ci // cropx, ci % cropx
                pix = (oy + crow) * self.resx + ccol + ox
                stride = np.int32(self.resx * self.resy)
                flat = (pix[None, :] + stride * np.arange(
                    self.n_patterns, dtype=np.int32)[:, None]).reshape(-1)
            self.active_pixels = flat
            self.active_data = np.zeros((flat.size,), np.float32)

        # projection-model parameters
        ps = props.get("pixel_size")
        self.aperture_radius = float(props.get("aperture_radius", 0.0))
        self.focus_distance = float(props.get("focus_distance", 0.0))
        if kind == "lens":
            assert not ("fov" in props and "pixel_size" in props), \
                "Specify either 'fov' or 'pixel_size', not both."
            assert ("fov" in props or "pixel_size" in props), \
                "Either 'fov' or 'pixel_size' must be specified."
            if "fov" in props:
                self.fov = float(props["fov"])
                ps = np.tan(np.deg2rad(self.fov) / 2) * 2 * \
                    self.focus_distance / self.resx
            else:
                ps = float(props["pixel_size"])
                self.fov = np.rad2deg(2 * np.arctan(
                    ps * self.resx / 2 / self.focus_distance))
        if ps is None:
            raise ValueError(f"[{kind}] missing 'pixel_size'")
        self.pixel_size = (float(ps), float(ps)) if np.isscalar(ps) \
            else (float(ps[0]), float(ps[1]))

        # motion
        if "motion" not in props:
            raise ValueError("Missing field 'motion'.")
        m = props["motion"]
        if isinstance(m, str):
            if m not in motions:
                raise ValueError(f"Invalid motion type: {m}")
            self.motion = motions[m](props)
        elif isinstance(m, dict):
            self.motion = motions[m["type"]](m | props)
        else:
            self.motion = m

    # -- pattern store -----------------------------------------------------

    def active_size(self):
        return int(self.active_data.shape[0])

    def size(self):
        return (self.n_patterns, self.resy, self.resx)

    def patterns(self, active_data=None):
        """Re-scatter sparse storage to the dense (n, resy, resx) stack."""
        data = self.active_data if active_data is None else active_data
        data = np.asarray(data, np.float32)
        dense = np.zeros((self.n_patterns * self.resy * self.resx,),
                         np.float32)
        dense[np.asarray(self.active_pixels)] = data
        return dense.reshape(self.n_patterns, self.resy, self.resx)

    def set_active(self, active_pixels, active_data):
        self.active_pixels = np.asarray(active_pixels, np.int32)
        self.active_data = np.asarray(active_data, np.float32)
        self.dense_identity = False
        if self.active_data.shape != self.active_pixels.shape:
            raise ValueError("active_data and active_pixels must have the "
                             "same length.")

    def static(self):
        return ProjectorStatic(self.kind, self.n_patterns, self.resx,
                               self.resy, self.active_size(),
                               identity=bool(self.dense_identity))

    def arrays(self):
        return {
            "active_pixels": np.asarray(self.active_pixels, np.int32),
            "pixel_size": np.asarray(self.pixel_size, np.float32),
            "aperture_radius": np.float32(self.aperture_radius),
            "focus_distance": np.float32(self.focus_distance),
            "motion_distance": np.float32(self.motion.distance),
        }


def sample_rays(pstat: ProjectorStatic, parr, active_pixels, lane, spp,
                sampler, ctr, regular_sampling, sample_time, clockwise):
    """Per-lane ray generation (pure, jittable).

    lane: (n,) global lane ids; active index = lane // spp.
    Returns (o, d, aidx, weight_scalar_factorless, ctr). The scalar ray
    weight inv_pdf / n_samples (reference projector.py:165) is returned
    separately by `ray_weight`.
    """
    aidx = (lane // jnp.uint32(spp)).astype(jnp.int32)
    # identity store: pixel id == active index, no 64M-table gather
    idx = aidx if pstat.identity else active_pixels[aidx]
    w, h = pstat.resx, pstat.resy
    emitter_idx = idx // (h * w)
    pixel_idx = idx % (h * w)
    py = pixel_idx // w
    px = pixel_idx - py * w
    pos = jnp.stack([px, py], -1).astype(jnp.float32)

    u_pos, ctr = sampler.next_2d(lane, ctr)
    if regular_sampling:
        pos_f = pos + 0.5
    else:
        pos_f = pos + u_pos
    s = pos_f / jnp.asarray([w, h], jnp.float32)

    u_t, ctr = sampler.next_1d(lane, ctr)
    time = emitter_idx.astype(jnp.float32)
    if sample_time:
        time = time + u_t
    time = time / pstat.n_patterns

    u_ap, ctr = sampler.next_2d(lane, ctr)

    psx, psy = parr["pixel_size"][0], parr["pixel_size"][1]
    ex, ey = w * psx, h * psy
    if pstat.kind == "collimated":
        o_cam = jnp.stack([(0.5 - s[..., 0]) * ex,
                           (0.5 - s[..., 1]) * ey,
                           jnp.zeros_like(s[..., 0])], -1)
        d_cam = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                                 o_cam.shape)
    elif pstat.kind == "telecentric":
        ap = parr["aperture_radius"] * square_to_uniform_disk_concentric(u_ap)
        ox = (0.5 - s[..., 0]) * ex + ap[..., 0]
        oy = (0.5 - s[..., 1]) * ey + ap[..., 1]
        o_cam = jnp.stack([ox, oy, jnp.zeros_like(ox)], -1)
        d = jnp.stack([-ap[..., 0], -ap[..., 1],
                       jnp.broadcast_to(parr["focus_distance"],
                                        ap[..., 0].shape)], -1)
        d_cam = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    elif pstat.kind == "lens":
        ap = parr["aperture_radius"] * square_to_uniform_disk_concentric(u_ap)
        o_cam = jnp.stack([ap[..., 0], ap[..., 1],
                           jnp.zeros_like(ap[..., 0])], -1)
        focus_p = jnp.stack([
            (0.5 - s[..., 0]) * ex,
            (0.5 - s[..., 1]) * ey,
            jnp.broadcast_to(parr["focus_distance"], s[..., 0].shape)], -1)
        d = focus_p - o_cam
        d_cam = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    else:
        raise ValueError(pstat.kind)

    # circular motion look-at (world-from-camera)
    alpha = 2.0 * jnp.pi * time
    if clockwise:
        alpha = -alpha
    origin = parr["motion_distance"] * jnp.stack(
        [jnp.cos(alpha), jnp.sin(alpha), jnp.zeros_like(alpha)], -1)
    # look_at(origin, 0, +z): dir = -normalize(origin); left = cross(up,dir)
    dirw = -origin / jnp.linalg.norm(origin, axis=-1, keepdims=True)
    up = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    left = jnp.cross(jnp.broadcast_to(up, dirw.shape), dirw)
    left = left / jnp.linalg.norm(left, axis=-1, keepdims=True)
    up2 = jnp.cross(dirw, left)
    R = jnp.stack([left, up2, dirw], axis=-1)
    o = apply_rt_point(R, origin, o_cam)
    d = apply_rt_vector(R, d_cam)
    return o, d, aidx, ctr


def ray_weight(pstat: ProjectorStatic, parr, spp, print_time):
    """inv_pdf / n_samples * print_time, identical for every lane
    (reference: projector.py:184-188,233,284 + common.py:111)."""
    ps = parr["pixel_size"]
    if pstat.kind == "lens":
        area = ps[0] * ps[0]
    else:
        area = ps[0] * ps[1]
    # inv_pdf = area * n_active ; n_samples = n_active * spp
    return area * print_time / spp

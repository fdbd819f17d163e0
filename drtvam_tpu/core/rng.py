"""Counter-based per-lane RNG for the wavefront path tracer.

Replaces the reference's PCG32 `independent` sampler (drtvam uses
sampler.seed(seed, wavefront) + per-lane next_1d/next_2d —
integrators/common.py:41-68). Requirements:
  * stateless & replayable: the adjoint pass re-traces the exact primal
    paths by re-seeding with the same seed (reference volume.py:116), so
    draw k of lane i must be a pure function of (seed, i, k);
  * cheap inside lax loops (no threefry tree — a handful of int ops).

We use the PCG3D hash (Jarzynski & Olano, "Hash Functions for GPU
Rendering", JCGT 2020) over the triple (seed, lane, counter). Each call
yields 3 independent 32-bit words; draws consume 1 or 2 of them and lanes
advance a per-lane uint32 counter.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_M = np.uint32(1664525)
_A = np.uint32(1013904223)
_INV24 = np.float32(1.0 / (1 << 24))  # numpy: no device commit at import


def _pcg3d(x, y, z):
    x = x * _M + _A
    y = y * _M + _A
    z = z * _M + _A
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def _to_unit(bits):
    # top 24 bits -> [0, 1) float32
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * _INV24


class Sampler:
    """Per-lane sampler over a wavefront.

    State is a single (n,) uint32 counter array carried through lax loops.
    Usage:
        ctr = sampler.init(n)
        u, ctr = sampler.next_1d(lane_ids, ctr)
    `lane_ids` stays fixed; the seed is baked at construction.
    """

    def __init__(self, seed):
        if isinstance(seed, int):
            seed = seed & 0xFFFFFFFF
        self.seed = jnp.asarray(seed).astype(jnp.uint32)

    def init(self, n: int):
        return jnp.zeros((n,), jnp.uint32)

    def next_1d(self, lane, ctr):
        x, _, _ = _pcg3d(self.seed + jnp.uint32(0x9E3779B9), lane, ctr)
        return _to_unit(x), ctr + jnp.uint32(1)

    def next_2d(self, lane, ctr):
        x, y, _ = _pcg3d(self.seed + jnp.uint32(0x9E3779B9), lane, ctr)
        return jnp.stack([_to_unit(x), _to_unit(y)], -1), ctr + jnp.uint32(1)

    def next_3d(self, lane, ctr):
        x, y, z = _pcg3d(self.seed + jnp.uint32(0x9E3779B9), lane, ctr)
        u = jnp.stack([_to_unit(x), _to_unit(y), _to_unit(z)], -1)
        return u, ctr + jnp.uint32(1)

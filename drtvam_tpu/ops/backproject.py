"""Ballistic dose backprojection: per-angle two-tap interpolation.

Consumes the per-angle 2D transport fields (ops/transport2d.py) and the
z-resampled pattern stack Pz (A, Zf, U):

    forward:  dose(Zf, YX)   = sum_a  Pz_a @ B_a
    adjoint:  Pz_bar(A,Zf,U) = dL @ B_a^T        (exact transpose)

where B_a(U, YX) is the sparse-2 linear-interpolation matrix defined by
(W_a, u_map_a): B[i, j] = W_j * max(0, 1 - |u_j - i|). Two
implementations with the same math, both summing in f32:

  * `xla`    — angle scan with take-based gathers and a scatter-add
               adjoint; runs anywhere and is the reference for tests;
  * `triton` — GPU kernels (Pallas through Triton). The forward keeps
               a (cells x z) dose tile in registers and loops over every
               angle inside the block, gathering the two taps of each
               cell from the pattern stack. The adjoint gathers, for
               each pattern column, the dose cotangent of the cells that
               interpolate from it, through a per-angle column->cells
               table built once per geometry: no atomics, so its sums
               are the same on every run.

`prepare(impl, W, Umap, U)` turns the fields into the operands an
implementation reads (once per engine); `backproject` is the
differentiable entry, a custom_vjp whose backward is `adjoint`.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .render import _zero_ct

IMPLS = ("xla", "triton")


def default_impl():
    """The implementation for the platform JAX runs on."""
    return "triton" if jax.devices()[0].platform == "gpu" else "xla"


def _check(impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown backprojection impl {impl!r} "
                         f"(have: {', '.join(IMPLS)})")


def _round_up(x, m):
    return -(-x // m) * m


def _taps(W, Umap, U):
    """(A, n) fields -> per-cell taps: the left column i0, clipped to
    [-1, U-1], and the weights of columns i0 and i0+1 (zero where the
    column is off the DMD or the cell is empty)."""
    i0 = jnp.floor(Umap).astype(jnp.int32)
    f = Umap - i0
    w0 = W * (1.0 - f) * ((i0 >= 0) & (i0 < U))
    w1 = W * f * ((i0 + 1 >= 0) & (i0 + 1 < U))
    return jnp.clip(i0, -1, U - 1), w0, w1


# --------------------------------------------------------------------------
# XLA implementation (reference / CPU)


def _fwd_xla(Pz, W, Umap):
    A, Zf, U = Pz.shape
    _, Y, X = W.shape
    i0, w0, w1 = _taps(W.reshape(A, Y * X), Umap.reshape(A, Y * X), U)
    i0c = jnp.maximum(i0, 0)
    i1c = jnp.minimum(i0 + 1, U - 1)

    def body(dose, inp):
        Pa, i0a, i1a, w0a, w1a = inp
        g = jnp.take(Pa, i0a, axis=1) * w0a + \
            jnp.take(Pa, i1a, axis=1) * w1a
        return dose + g, None

    dose0 = jnp.zeros((Zf, Y * X), jnp.float32)
    dose, _ = jax.lax.scan(body, dose0, (Pz, i0c, i1c, w0, w1))
    return dose


def _bwd_xla(dL, W, Umap, U):
    A, Y, X = W.shape
    Zf = dL.shape[0]
    i0, w0, w1 = _taps(W.reshape(A, Y * X), Umap.reshape(A, Y * X), U)
    i0c = jnp.maximum(i0, 0)
    i1c = jnp.minimum(i0 + 1, U - 1)

    def body(_, inp):
        i0a, i1a, w0a, w1a = inp
        Pa = jnp.zeros((Zf, U), jnp.float32)
        Pa = Pa.at[:, i0a].add(dL * w0a)
        Pa = Pa.at[:, i1a].add(dL * w1a)
        return None, Pa

    _, Pbar = jax.lax.scan(body, None, (i0c, i1c, w0, w1))
    return Pbar


# --------------------------------------------------------------------------
# Triton kernels (GPU)
#
# Cells are visited in TY x TX spatial tiles: a tile's rays land on a
# narrow band of DMD columns, so the two gathers per cell and angle hit
# the same few cache lines. The pattern stack and the dose cotangent are
# laid out z-minor ((A, U, Zp) and (cells, Zp)), so each gathered row is
# bz contiguous floats.

TY, TX = 8, 16           # cells per forward block
TILE = TY * TX
BZ = 64                  # most dose rows per block
BU = 32                  # pattern columns per adjoint block
NUM_WARPS = 4


def _bz(Zf):
    return min(BZ, pl.next_power_of_2(Zf))


def _tile_major(x):
    """(L, Y, X) -> (L, Yp*Xp), TY x TX tiles in row-major tile order,
    zero-padded to whole tiles."""
    L, Y, X = x.shape
    Yp, Xp = _round_up(Y, TY), _round_up(X, TX)
    x = jnp.pad(x, ((0, 0), (0, Yp - Y), (0, Xp - X)))
    x = x.reshape(L, Yp // TY, TY, Xp // TX, TX).transpose(0, 1, 3, 2, 4)
    return x.reshape(L, Yp * Xp)


def _raster(x, Y, X):
    """Inverse of _tile_major: (L, Yp*Xp) -> (L, Y*X)."""
    L = x.shape[0]
    Yp, Xp = _round_up(Y, TY), _round_up(X, TX)
    x = x.reshape(L, Yp // TY, Xp // TX, TY, TX).transpose(0, 1, 3, 2, 4)
    return x.reshape(L, Yp, Xp)[:, :Y, :X].reshape(L, Y * X)


@partial(jax.tree_util.register_dataclass,
         data_fields=["i0", "w0", "w1", "cells", "cw", "kmax"],
         meta_fields=["Y", "X"])
@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Operands of the `triton` kernels, every array leading with A.

    i0, w0, w1: (A, Yp*Xp) taps of each cell, tile-major.
    cells, cw: (A, K, Up) adjoint table: the k-th cell (tile-major
        index) interpolating from column u, and its weight; zero
        weights pad each column to K entries.
    kmax: (A, Up // BU) entries the adjoint block of each BU columns
        has to visit.
    """
    i0: jax.Array
    w0: jax.Array
    w1: jax.Array
    cells: jax.Array
    cw: jax.Array
    kmax: jax.Array
    Y: int
    X: int


@partial(jax.jit, static_argnums=(3,))
def _sorted_taps(i0, w0, w1, U):
    """Both taps of every cell, sorted by column per angle (used taps
    first, in cell order), and each column's entry count."""
    A, n = i0.shape
    Up = _round_up(U, BU)
    col = jnp.concatenate([jnp.maximum(i0, 0), jnp.minimum(i0 + 1, U - 1)],
                          axis=1)
    w = jnp.concatenate([w0, w1], axis=1)
    col = jnp.where(w != 0, col, Up)
    order = jnp.argsort(col, axis=1, stable=True)
    col = jnp.take_along_axis(col, order, axis=1)
    w = jnp.take_along_axis(w, order, axis=1)
    count = jax.vmap(lambda c: jnp.bincount(c, length=Up + 1))(col)
    return col, w, (order % n).astype(jnp.int32), count[:, :Up]


@partial(jax.jit, static_argnums=(4,))
def _fill_table(col, w, cell, count, K):
    A, m = col.shape
    Up = count.shape[1]
    start = jnp.cumsum(count, axis=1) - count
    rank = jnp.arange(m)[None] - jnp.take_along_axis(
        start, jnp.minimum(col, Up - 1), axis=1)
    a = jnp.broadcast_to(jnp.arange(A)[:, None], (A, m))
    # unused taps carry col == Up, out of bounds: dropped
    cells = jnp.zeros((A, K, Up), jnp.int32).at[a, rank, col].set(
        cell, mode="drop")
    cw = jnp.zeros((A, K, Up), jnp.float32).at[a, rank, col].set(
        w, mode="drop")
    kmax = count.reshape(A, Up // BU, BU).max(axis=2)
    return cells, cw, kmax


def _tile_geometry(W, Umap, U):
    A, Y, X = W.shape
    i0, w0, w1 = _taps(_tile_major(W), _tile_major(Umap), U)
    col, w, cell, count = _sorted_taps(i0, w0, w1, U)
    K = max(int(count.max()), 1)   # one sync per geometry: table depth
    cells, cw, kmax = _fill_table(col, w, cell, count, K)
    return TileGeometry(i0, w0, w1, cells, cw, kmax, Y, X)


def _fwd_kernel(pz_ref, i0_ref, w0_ref, w1_ref, out_ref):
    """out (TILE, bz) = sum over all angles of the two-tap gathers."""
    A, U = pz_ref.shape[0], pz_ref.shape[1]
    bz = out_ref.shape[1]
    zs = pl.ds(pl.program_id(1) * bz, bz)

    def body(a, acc):
        i0 = i0_ref[a, :]
        p0 = pz_ref[a, jnp.maximum(i0, 0), zs]
        p1 = pz_ref[a, jnp.minimum(i0 + 1, U - 1), zs]
        return acc + (p0 * w0_ref[a, :][:, None] +
                      p1 * w1_ref[a, :][:, None])

    out_ref[...] = jax.lax.fori_loop(
        0, A, body, jnp.zeros(out_ref.shape, jnp.float32))


def _bwd_kernel(kmax_ref, cells_ref, cw_ref, dl_ref, out_ref):
    """out (BU, bz) of one angle = sum_k cw[k, u] * dL[cells[k, u], z]."""
    bz = out_ref.shape[1]
    zs = pl.ds(pl.program_id(2) * bz, bz)

    def body(k, acc):
        return acc + dl_ref[cells_ref[k, :], zs] * cw_ref[k, :][:, None]

    n_k = kmax_ref[pl.program_id(0), pl.program_id(1)]
    out_ref[...] = jax.lax.fori_loop(
        0, n_k, body, jnp.zeros(out_ref.shape, jnp.float32))


def _fwd_triton(Pz, geo, interpret=False):
    A, Zf, U = Pz.shape
    n = geo.i0.shape[1]
    bz = _bz(Zf)
    Zp = _round_up(Zf, bz)
    PzT = jnp.pad(Pz.transpose(0, 2, 1), ((0, 0), (0, 0), (0, Zp - Zf)))
    out = pl.pallas_call(
        _fwd_kernel,
        grid=(n // TILE, Zp // bz),
        in_specs=[
            pl.BlockSpec((A, U, Zp), lambda t, z: (0, 0, 0)),
            pl.BlockSpec((A, TILE), lambda t, z: (0, t)),
            pl.BlockSpec((A, TILE), lambda t, z: (0, t)),
            pl.BlockSpec((A, TILE), lambda t, z: (0, t)),
        ],
        out_specs=pl.BlockSpec((TILE, bz), lambda t, z: (t, z)),
        out_shape=jax.ShapeDtypeStruct((n, Zp), jnp.float32),
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="backproject_fwd",
    )(PzT, geo.i0, geo.w0, geo.w1)
    return _raster(out[:, :Zf].T, geo.Y, geo.X)


def _bwd_triton(dL, geo, U, interpret=False):
    Zf = dL.shape[0]
    A, K, Up = geo.cells.shape
    bz = _bz(Zf)
    Zp = _round_up(Zf, bz)
    dLt = _tile_major(dL.reshape(Zf, geo.Y, geo.X)).T
    dLt = jnp.pad(dLt, ((0, 0), (0, Zp - Zf)))
    out = pl.pallas_call(
        _bwd_kernel,
        grid=(A, Up // BU, Zp // bz),
        in_specs=[
            pl.BlockSpec(geo.kmax.shape, lambda a, u, z: (0, 0)),
            pl.BlockSpec((None, K, BU), lambda a, u, z: (a, 0, u)),
            pl.BlockSpec((None, K, BU), lambda a, u, z: (a, 0, u)),
            pl.BlockSpec(dLt.shape, lambda a, u, z: (0, 0)),
        ],
        out_specs=pl.BlockSpec((None, BU, bz), lambda a, u, z: (a, u, z)),
        out_shape=jax.ShapeDtypeStruct((A, Up, Zp), jnp.float32),
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="backproject_bwd",
    )(geo.kmax, geo.cells, geo.cw, dLt)
    return out[:, :U, :Zf].transpose(0, 2, 1)


# --------------------------------------------------------------------------
# dispatch + differentiable entry


def prepare(impl, W, Umap, U):
    """(A, Y, X) transport fields -> the operands `impl` reads; every
    leaf leads with the angle axis, so the pytree shards over angles."""
    _check(impl)
    if impl == "xla":
        return {"W": W, "Umap": Umap}
    return _tile_geometry(W, Umap, U)


def forward(impl, Pz, geo):
    """dose(Zf, Y*X) = sum_a Pz_a @ B_a."""
    _check(impl)
    if impl == "xla":
        return _fwd_xla(Pz, geo["W"], geo["Umap"])
    return _fwd_triton(Pz, geo)


def adjoint(impl, dL, geo, U):
    """Pz_bar(A, Zf, U) = dL @ B_a^T."""
    _check(impl)
    if impl == "xla":
        return _bwd_xla(dL, geo["W"], geo["Umap"], U)
    return _bwd_triton(dL, geo, U)


def zero_cotangent(tree):
    """Zero cotangents for a pytree of arrays (float0 for int leaves)."""
    return jax.tree.map(_zero_ct, tree)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def backproject(impl, Pz, geo):
    """Differentiable forward(impl, Pz, geo) w.r.t. the pattern stack."""
    return forward(impl, Pz, geo)


def _bp_fwd(impl, Pz, geo):
    return forward(impl, Pz, geo), (geo, Pz.shape[2])


def _bp_bwd(impl, res, dL):
    geo, U = res
    return adjoint(impl, dL, geo, U), zero_cotangent(geo)


backproject.defvjp(_bp_fwd, _bp_bwd)

#!/usr/bin/env python3
"""Backprojection on the GPU: each direction's Triton kernel against the
plain XLA forms, and the whole ballistic L-BFGS step with either pair.

    python benchmarks/micro_backproject.py [--reps 5] [--steps 4]

Works on the transport fields of chip_smoke.py's cylindrical job (400
angles, 400x400 DMD, 256^3 dose grid: A=400, Zf=256, U=400, 256^2 cells)
and prints warm medians of `--reps` calls, each ending in
block_until_ready:

  * the Triton operands: build time (cold, then warm) and device bytes;
  * forward: the kernel; the plain scan (`_fwd_xla`); the plain scan
    with G angles summed per carry update, G = 4, 8, 16;
  * adjoint: the kernel; the plain scatter-add (`_bwd_xla`); a plain
    gather over the kernel's column->cells table, scanned over angles;
  * the ballistic job through optimize(): median of warm L-BFGS steps
    2..--steps, once per pair in the order xla, triton, xla, triton.

Every variant is checked against the reference before it is timed.
Needs a GPU.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from drtvam_tpu.ops import backproject as bp  # noqa: E402


def fwd_grouped(Pz, W, Umap, G):
    """_fwd_xla with G angles gathered and summed per carry update."""
    A, Zf, U = Pz.shape
    _, Y, X = W.shape
    i0, w0, w1 = bp._taps(W.reshape(A, Y * X), Umap.reshape(A, Y * X), U)
    i0c, i1c = jnp.maximum(i0, 0), jnp.minimum(i0 + 1, U - 1)

    def one(Pa, i0a, i1a, w0a, w1a):
        return jnp.take(Pa, i0a, axis=1) * w0a + \
            jnp.take(Pa, i1a, axis=1) * w1a

    def body(dose, inp):
        return dose + jax.vmap(one)(*inp).sum(axis=0), None

    groups = [x.reshape(A // G, G, *x.shape[1:])
              for x in (Pz, i0c, i1c, w0, w1)]
    dose, _ = jax.lax.scan(body, jnp.zeros((Zf, Y * X), jnp.float32),
                           groups)
    return dose


def bwd_table(dL, geo, U):
    """The Triton adjoint's gather over the column->cells table, as a
    plain scan over angles."""
    Zf = dL.shape[0]
    dLt = bp._tile_major(dL.reshape(Zf, geo.Y, geo.X))

    def body(_, inp):
        cells, cw = inp                       # (K, Up)
        return None, (jnp.take(dLt, cells, axis=1) * cw).sum(axis=1)

    _, out = jax.lax.scan(body, None, (geo.cells, geo.cw))
    return out[:, :, :U]


def operands(W, Umap, U):
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        geo = jax.block_until_ready(bp.prepare("triton", W, Umap, U))
        smoke.timed(f"triton operands build ({run})",
                    time.perf_counter() - t0)
    taps = sum(x.nbytes for x in (geo.i0, geo.w0, geo.w1))
    table = geo.cells.nbytes + geo.cw.nbytes
    smoke.say(f"triton operands: taps {taps / 2**20:.1f} MiB, adjoint "
              f"table {table / 2**20:.1f} MiB (depth K="
              f"{geo.cells.shape[1]})")
    return geo


def kernels(reps, seed=0):
    W, Umap = smoke.cylinder_fields()
    A, Y, X = W.shape
    U, Zf = smoke.DMD, smoke.FILM
    geo = operands(W, Umap, U)
    rng = np.random.default_rng(seed)
    Pz = jnp.asarray(rng.random((A, Zf, U), np.float32))
    dL = jnp.asarray(rng.random((Zf, Y * X), np.float32))
    smoke.say(f"shapes: A={A} Zf={Zf} U={U} Y={Y} X={X}")

    cases = [("forward", bp._fwd_xla, (Pz, W, Umap), [
        ("triton kernel", bp._fwd_triton, (Pz, geo)),
        ("plain scan (reference)", bp._fwd_xla, (Pz, W, Umap)),
    ] + [(f"plain scan, {G} angles per update",
          lambda p, w, u, G=G: fwd_grouped(p, w, u, G), (Pz, W, Umap))
         for G in (4, 8, 16)]),
        ("adjoint", lambda d, w, u: bp._bwd_xla(d, w, u, U), (dL, W, Umap), [
            ("triton kernel", lambda d, g: bp._bwd_triton(d, g, U),
             (dL, geo)),
            ("plain scatter-add (reference)",
             lambda d, w, u: bp._bwd_xla(d, w, u, U), (dL, W, Umap)),
            ("plain gather over the table",
             lambda d, g: bwd_table(d, g, U), (dL, geo)),
        ])]
    for direction, ref_fn, ref_args, variants in cases:
        ref = jax.jit(ref_fn)(*ref_args)
        for name, fn, args in variants:
            fn = jax.jit(fn)
            err = smoke._rel_err(fn(*args), ref)
            assert err <= smoke.RTOL, f"{direction} {name}: {err:.3e}"
            smoke.timed(f"{direction}, {name} (warm median of {reps}; "
                        f"max rel err {err:.2e})",
                        smoke._median_time(fn, *args, n=reps))


def whole_steps(n_steps):
    from drtvam_tpu.ops import ballistic
    from drtvam_tpu.opt.optimize import optimize

    for impl in ("xla", "triton", "xla", "triton"):
        # the engine takes its pair from the platform; pin it instead
        ballistic.default_impl = lambda impl=impl: impl
        cfg = smoke.job_config(f"step_{impl}", n_steps=n_steps)
        optimize(cfg)
        steps = np.load(os.path.join(cfg["output"], "timing.npy"))
        warm = steps[1:n_steps].sum(axis=1)
        smoke.timed(f"{impl}: warm whole L-BFGS steps 2-{n_steps} median",
                    float(np.median(warm)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    smoke.device_phase(1)
    kernels(args.reps)
    whole_steps(args.steps)


if __name__ == "__main__":
    main()

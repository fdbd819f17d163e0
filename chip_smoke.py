#!/usr/bin/env python3
"""Smoke test of the print-job path on NVIDIA GPUs.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # four cards: sharded paths only

One card, one process, at the benchmark width (cylindrical or square
vial, 400 angles, 400x400 DMD at 25 um, 256^3 dose grid):

  1. the device, the card's name and power limit, the compile cache;
  2. the backprojection kernels against the plain reference
     (`_fwd_xla` / `_bwd_xla`) on the transport fields of the
     cylindrical scene, with warm times of both;
  3. the ballistic cylindrical job through `optimize()`, 3 L-BFGS steps;
  4. the cylindrical albedo-0.5 scattering job (hybrid engine), 2 steps;
  5. the square-vial surface-aware job with Radon culling, 2 steps.

Phases 3-5 check that every loss is finite and falls from step to step
and that the CLI artifacts exist (written under out/smoke/). Any failure
raises: the script then exits non-zero without a result line. It also
fails when JAX finds no GPU. The last line of stdout is one JSON object
naming the device.

`--four-cards` runs the multi-device checks of
`__graft_entry__.dryrun_multichip` on 4 cards and the angle-sharded
ballistic engine (100 angles per card) against the one-card engine,
with each card's memory in use.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ANGLES, DMD, FILM = 400, 400, 256
REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "out", "smoke")
# Both directions sum in f32 with no tensor-core op. The forward adds
# the same products in the same angle order as the reference; the plain
# adjoint's scatter-add runs as atomics in an order that changes from
# run to run, the kernel's gather in table order. Rounding differences
# of that kind stay far below 1e-5 of the largest entry.
RTOL = 1e-5

CARD = ""
COMPILE = {"secs": 0.0, "n": 0, "hits": 0}


def say(msg):
    print(msg, flush=True)


def timed(msg, secs):
    say(f"[{CARD}] {msg}: {secs:.6f} s")


def _listen_compiles():
    from jax import monitoring

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            COMPILE["secs"] += secs
            COMPILE["n"] += 1

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            COMPILE["hits"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)


def device_phase(n_cards):
    """Phase 1. Returns the device record of the result line."""
    global CARD
    import jax
    from drtvam_tpu.utils.jax_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devs[0].platform}")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    CARD = smi.splitlines()[0].strip()
    say(smi)
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    say(f"compile cache: {enable_compile_cache()}")
    _listen_compiles()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def job_config(name, albedo=0.0, square=False, surface_aware=False,
               n_steps=3, n_angles=N_ANGLES, dmd=DMD, film=FILM):
    """The benchmark print job as a CLI config (outputs under OUT)."""
    from drtvam_tpu.ops.mesh import make_box_with_hole, save_ply

    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    mesh_path = os.path.join(out, "target.ply")
    save_ply(make_box_with_hole((1.0, 0.8, 2.0), 0.35,
                                hole_center_xy=(-0.4, 0.0), segments=99),
             mesh_path)
    med = {"ior": 1.40, "phase": {"type": "rayleigh"},
           "extinction": 0.05, "albedo": albedo}
    if square:
        vial = {"type": "square", "w_int": 6.8, "w_ext": 7.2,
                "ior": 1.54, "medium": med}
    else:
        vial = {"type": "cylindrical", "r_int": 4.75, "r_ext": 5.0,
                "ior": 1.54, "medium": med}
    grid = {"type": "vfilm", "resx": film, "resy": film, "resz": film}
    # scattering jobs: delta tracking for the residual and the final
    # render alike, one residual ray per pixel, as bench.py does
    sensor = {"type": "delta" if albedo > 0.0 else "dda",
              "scalex": 10, "scaley": 10, "scalez": 10,
              "film": dict(grid, surface_aware=surface_aware)}
    cfg = {
        "vial": vial,
        "projector": {"type": "collimated", "n_patterns": n_angles,
                      "resx": dmd, "resy": dmd, "pixel_size": 10.0 / dmd,
                      "motion": "circular", "distance": 30},
        "sensor": sensor,
        "target": {"filename": mesh_path, "size": 10.0},
        "loss": {"type": "threshold", "tl": 0.9, "tu": 0.95},
        "n_steps": n_steps,
        "output": out,
    }
    if surface_aware:
        cfg["final_sensor"] = dict(sensor, film=grid)
        cfg["filter_radon"] = True
    if albedo > 0.0:
        cfg.update(spp=1, spp_ref=1)
    return cfg


def _median_time(fn, *args, n=5):
    import jax
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rel_err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.all(np.isfinite(out)), "non-finite kernel output"
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def cylinder_fields(n_angles=N_ANGLES, dmd=DMD, film=FILM):
    """(W, Umap) transport fields of the cylindrical job's scene."""
    from drtvam_tpu.models.scene import Scene
    from drtvam_tpu.ops.ballistic import BallisticEngine

    scene = Scene(job_config("kernels", n_angles=n_angles, dmd=dmd,
                             film=film))
    static, arr = scene.build(mode="volume", include_target=False,
                              max_depth=6, rr_depth=6)
    t0 = time.perf_counter()
    eng = BallisticEngine(static, arr, impl="xla")
    timed(f"transport fields ({eng.transport_builder} builder)",
          time.perf_counter() - t0)
    return eng.geo["W"], eng.geo["Umap"]


def kernel_phase(n_angles=N_ANGLES, dmd=DMD, film=FILM, seed=0):
    """Phase 2: each backprojection direction against the reference."""
    import jax
    import jax.numpy as jnp
    from drtvam_tpu.ops import backproject as bp

    W, Umap = cylinder_fields(n_angles, dmd, film)
    A, Y, X = W.shape
    U, Zf = dmd, film
    t0 = time.perf_counter()
    geo = jax.block_until_ready(bp.prepare("triton", W, Umap, U))
    timed(f"triton operands (adjoint table depth {geo.cells.shape[1]})",
          time.perf_counter() - t0)
    rng = np.random.default_rng(seed)
    Pz = jnp.asarray(rng.random((A, Zf, U), np.float32))
    dL = jnp.asarray(rng.random((Zf, Y * X), np.float32))
    say(f"kernel shapes: A={A} Zf={Zf} U={U} Y={Y} X={X}")

    for name, ref_fn, ker_fn, ref_args, ker_args in (
            ("forward", bp._fwd_xla, bp._fwd_triton, (Pz, W, Umap),
             (Pz, geo)),
            ("adjoint", lambda d, w, u: bp._bwd_xla(d, w, u, U),
             lambda d, g: bp._bwd_triton(d, g, U), (dL, W, Umap),
             (dL, geo))):
        ref_j, ker_j = jax.jit(ref_fn), jax.jit(ker_fn)
        err = _rel_err(ker_j(*ker_args), ref_j(*ref_args))
        say(f"{name}: max |kernel - reference| / max |reference| = "
            f"{err:.3e} (limit {RTOL:.0e})")
        assert err <= RTOL, f"{name} kernel disagrees with the reference"
        timed(f"{name} kernel (warm median of 5)",
              _median_time(ker_j, *ker_args))
        timed(f"{name} plain reference (warm median of 5)",
              _median_time(ref_j, *ref_args))


def run_job(name, n_steps, **kw):
    """Phases 3-5: one print job through optimize(), checked."""
    from drtvam_tpu.opt.optimize import optimize

    cfg = job_config(name, n_steps=n_steps, **kw)
    out = cfg["output"]
    say(f"--- job {name}: {n_steps} L-BFGS steps")
    t0 = time.perf_counter()
    optimize(cfg)
    wall = time.perf_counter() - t0
    loss = np.load(os.path.join(out, "loss.npy"))[:n_steps]
    steps = np.load(os.path.join(out, "timing.npy"))[:n_steps].sum(axis=1)
    say(f"{name}: losses {' '.join(f'{v:.6e}' for v in loss)}")
    assert np.all(np.isfinite(loss)), f"{name}: non-finite loss"
    assert np.all(np.diff(loss) < 0), f"{name}: loss does not fall"
    target = ["target_in.exr", "target_out.exr"] \
        if kw.get("surface_aware") else ["target.exr"]
    last_pattern = f"{cfg['projector']['n_patterns'] - 1:04d}.exr"
    need = ["final.exr", "final.npy", "target.npy", "loss.npy",
            "timing.npy", "patterns.npz", "patterns_normalized_uint8.npz",
            "metrics.json", os.path.join("patterns", last_pattern)] + target
    try:
        import matplotlib  # noqa: F401
        need.append("histogram.png")
    except ImportError:
        pass
    missing = [f for f in need if not os.path.exists(os.path.join(out, f))]
    assert not missing, f"{name}: missing artifacts {missing}"
    with open(os.path.join(out, "metrics.json")) as f:
        iou = json.load(f)["best_iou"]
    say(f"{name}: artifacts present, best IoU after {n_steps} steps "
        f"{iou:.4f}")
    timed(f"{name} step 1 (cold: includes compiles)", steps[0])
    for i in range(1, n_steps):
        timed(f"{name} step {i + 1} (warm)", steps[i])
    timed(f"{name} whole job incl. scene, compiles, final render, "
          "artifacts", wall)


def _mib_in_use(device):
    return device.memory_stats()["bytes_in_use"] / 2**20


def four_card_phase(n_angles=N_ANGLES, dmd=DMD, film=FILM):
    """Multi-device checks on 4 devices, each against one device."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__
    from drtvam_tpu.models.scene import Scene
    from drtvam_tpu.ops.ballistic import BallisticEngine
    from drtvam_tpu.parallel.shard import make_mesh, shard_ballistic_engine

    __graft_entry__.dryrun_multichip(4)

    mesh = make_mesh(jax.devices()[:4])
    scene = Scene(job_config("four_cards", n_angles=n_angles, dmd=dmd,
                             film=film))
    static, arr = scene.build(mode="volume", include_target=False,
                              max_depth=6, rr_depth=6)
    inv_vol = jnp.float32(1.0 / scene.sensor.voxel_volume)
    eng4 = shard_ballistic_engine(BallisticEngine(static, arr), mesh)
    for d in jax.devices()[:4]:
        say(f"{d}: {_mib_in_use(d):.1f} MiB in use with the "
            "angle-sharded operands placed")
    eng1 = BallisticEngine(static, arr)
    n = scene.projector.active_size()
    data = jnp.linspace(0.5, 2.0, n, dtype=jnp.float32)

    def value_grad(eng):
        def f(d):
            v = eng.render_vol(d, inv_vol)
            return jnp.mean(jnp.square(v)), v
        return jax.jit(jax.value_and_grad(f, has_aux=True))(data)

    (_, v4), g4 = value_grad(eng4)
    (_, v1), g1 = value_grad(eng1)
    assert float(jnp.sum(v1)) > 0, "empty dose"
    dose_err = _rel_err(v4, v1)
    grad_err = _rel_err(g4, g1)
    say(f"angle-sharded ballistic engine, {n_angles} angles over 4 cards "
        f"vs 1 card: max rel dose err {dose_err:.3e}, max rel grad err "
        f"{grad_err:.3e}")
    assert dose_err <= RTOL and grad_err <= RTOL


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded checks")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    device = device_phase(4 if args.four_cards else 1)
    if args.four_cards:
        four_card_phase()
    else:
        kernel_phase()
        run_job("ballistic", 3)
        run_job("scattering", 2, albedo=0.5)
        run_job("surface_aware", 2, albedo=0.5, square=True,
                surface_aware=True)
    say(f"XLA compiles: {COMPILE['n']} taking {COMPILE['secs']:.1f} s, "
        f"{COMPILE['hits']} persistent-cache hits")
    timed("whole smoke run", time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

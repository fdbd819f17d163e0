"""Microbenchmark of the wavefront path tracer on the live device.

Measures forward and adjoint rays/s for (a) the pure-absorption
cylindrical scene and (b) the scattering scene (albedo 0.5, rayleigh),
at configurable lane counts. The scattering workload class is the
reference's '16 rays/pixel cylindrical scattering' benchmark
(README.md:133: L40S 14m10s for the 400-angle 400x400 optimization,
i.e. ~0.1 Grays/s fwd+bwd sustained).
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from drtvam_tpu.utils.jax_cache import enable_compile_cache

enable_compile_cache()


def build(albedo, film, dmd, n_patterns, estimator="dda"):
    from drtvam_tpu.models.scene import Scene
    from drtvam_tpu.ops.mesh import make_box_with_hole, save_ply
    mesh_path = os.path.join(tempfile.gettempdir(), "mw_target.ply")
    if not os.path.exists(mesh_path):
        save_ply(make_box_with_hole((2.0, 2.0, 1.0), 0.6, segments=49),
                 mesh_path)
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7.0, "r_ext": 7.5,
                 "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.05, "albedo": albedo}},
        "projector": {"type": "collimated", "n_patterns": n_patterns,
                      "resx": dmd, "resy": dmd, "pixel_size": 10.0 / dmd,
                      "motion": "circular", "distance": 30},
        "sensor": {"type": estimator, "scalex": 10, "scaley": 10,
                   "scalez": 10, "majorant": 0.1,
                   "film": {"type": "vfilm", "resx": film, "resy": film,
                            "resz": film}},
        "target": {"filename": mesh_path, "size": 8.0},
        "output": tempfile.gettempdir(),
    }
    return Scene(cfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--film", type=int, default=128)
    ap.add_argument("--dmd", type=int, default=128)
    ap.add_argument("--angles", type=int, default=64)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--albedo", type=float, nargs="+", default=[0.0, 0.5])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from drtvam_tpu.ops.render import render, _adjoint

    print(f"# platform={jax.devices()[0].platform} dmd={args.dmd} "
          f"angles={args.angles} spp={args.spp} film={args.film}",
          file=sys.stderr)

    for albedo in args.albedo:
        scene = build(albedo, args.film, args.dmd, args.angles)
        static, arr = scene.build(mode="volume", include_target=False,
                                  max_depth=6, rr_depth=6)
        inv_vol = jnp.float32(1.0 / scene.sensor.voxel_volume)
        n = scene.projector.active_size()
        n_rays = n * args.spp
        data = jnp.ones((n,), jnp.float32)

        fwd = jax.jit(lambda d, arr_: render(
            static, arr_, d, inv_vol, seed=0, spp=args.spp,
            chunk=args.chunk))
        t0 = time.perf_counter()
        vol = jax.block_until_ready(fwd(data, arr))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            vol = jax.block_until_ready(fwd(data, arr))
        t_fwd = (time.perf_counter() - t0) / args.reps

        dL = (vol * 1e-6).reshape(-1)
        bwd = jax.jit(lambda arr_, dL_: _adjoint(
            static, arr_, jnp.uint32(0), args.spp, args.chunk, dL_)[0])
        jax.block_until_ready(bwd(arr, dL))
        t0 = time.perf_counter()
        for _ in range(args.reps):
            jax.block_until_ready(bwd(arr, dL))
        t_bwd = (time.perf_counter() - t0) / args.reps

        print(f"albedo={albedo}: fwd {t_fwd*1e3:9.1f} ms "
              f"({n_rays/t_fwd/1e6:8.2f} Mrays/s)   "
              f"bwd {t_bwd*1e3:9.1f} ms ({n_rays/t_bwd/1e6:8.2f} Mrays/s)"
              f"   [compile {compile_s:.0f}s, dose sum "
              f"{float(vol.sum()):.3e}]")


if __name__ == "__main__":
    main()

"""Microbenchmark of the hybrid scattering engine on the live device.

Measures forward and gradient wall-clock + rays/s for the
ballistic backprojection + scattered-residual decomposition
(ops/hybrid.py) at configurable scale. The workload class is the reference's published
'cylindrical scattering, 16 rays/pixel' benchmark (README.md:133:
L40S 14m10s for 400 angles x 400x400 DMD x 40 L-BFGS iterations).
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


def build(albedo, extinction, film, dmd, n_patterns):
    from drtvam_tpu.models.scene import Scene
    from drtvam_tpu.ops.mesh import make_box_with_hole, save_ply
    mesh_path = os.path.join(tempfile.gettempdir(), "mh_target.ply")
    if not os.path.exists(mesh_path):
        save_ply(make_box_with_hole((2.0, 2.0, 1.0), 0.6, segments=49),
                 mesh_path)
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7.0, "r_ext": 7.5,
                 "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": extinction, "albedo": albedo}},
        "projector": {"type": "collimated", "n_patterns": n_patterns,
                      "resx": dmd, "resy": dmd, "pixel_size": 10.0 / dmd,
                      "motion": "circular", "distance": 30},
        "sensor": {"type": "dda", "scalex": 10, "scaley": 10,
                   "scalez": 10,
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
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--spp-grad", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--albedo", type=float, default=0.9)
    ap.add_argument("--extinction", type=float, default=0.09)
    ap.add_argument("--estimator", default="delta",
                    choices=["dda", "ratio", "delta"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-first-scatter", action="store_true",
                    help="analog residual prefix (pre-r04 behavior)")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from drtvam_tpu.ops.hybrid import ScatteringEngine

    scene = build(args.albedo, args.extinction, args.film, args.dmd,
                  args.angles)
    static, arr = scene.build(mode="volume", include_target=False,
                              max_depth=6, rr_depth=6)
    inv_vol = jnp.float32(1.0 / scene.sensor.voxel_volume)
    n = scene.projector.active_size()
    data = jnp.ones((n,), jnp.float32)
    spp_grad = args.spp if args.spp_grad is None else args.spp_grad

    t0 = time.perf_counter()
    eng = ScatteringEngine(static, arr, spp=args.spp, spp_grad=spp_grad,
                           chunk=args.chunk, estimator=args.estimator,
                           first_scatter=not args.no_first_scatter)
    ep = eng.params()
    jax.block_until_ready(ep["ball"]["geo"])
    t_build = time.perf_counter() - t0
    print(f"# platform={jax.devices()[0].platform} dmd={args.dmd} "
          f"angles={args.angles} spp={args.spp}/{spp_grad} "
          f"film={args.film} albedo={args.albedo} "
          f"estimator={args.estimator} engine build {t_build:.1f}s",
          file=sys.stderr)

    fwd = jax.jit(lambda d, p, s: eng.render_vol(d, inv_vol, seed=s,
                                                 params=p))
    seed = jnp.uint32(0)
    t0 = time.perf_counter()
    vol = jax.block_until_ready(fwd(data, ep, seed))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in range(args.reps):
        vol = jax.block_until_ready(fwd(data, ep, jnp.uint32(r)))
    t_fwd = (time.perf_counter() - t0) / args.reps

    w = (vol * 1e-6)

    @jax.jit
    def gfn(d, p, s):
        return jax.grad(
            lambda dd: jnp.vdot(eng.render_vol(dd, inv_vol, seed=s,
                                               params=p), w))(d)

    jax.block_until_ready(gfn(data, ep, seed))
    t0 = time.perf_counter()
    for r in range(args.reps):
        jax.block_until_ready(gfn(data, ep, jnp.uint32(r)))
    t_bwd = (time.perf_counter() - t0) / args.reps

    n_rays_f = n * args.spp
    n_rays_b = n * args.spp + n * spp_grad
    print(f"fwd {t_fwd*1e3:9.1f} ms ({n_rays_f/t_fwd/1e6:8.2f} Mrays/s)  "
          f"fwd+vjp {t_bwd*1e3:9.1f} ms ({n_rays_b/t_bwd/1e6:8.2f} "
          f"Mrays/s)   [compile {compile_s:.0f}s, dose sum "
          f"{float(vol.sum()):.4e}]")


if __name__ == "__main__":
    main()

"""Optimization driver + CLI (reference: src/drtvam/optimize.py).

`optimize(config)` mirrors the reference driver end to end: scene
assembly, target discretization (binary or surface-aware), Radon/corner
DMD-pixel culling, the render/loss/adjoint/step loop with progressive
scattering warm-up, pattern clamping, convergence break, the final
high-quality render, and the full artifact set (final.exr/npy,
loss/timing.npy, per-pattern EXRs, patterns.npz + normalized uint8,
histogram.png, pattern efficiency). `main()` is the `drtvam`-style CLI
with dotted -D overrides, --backend, and --forward_mode/--patterns.

Timing semantics match optimize.py:287-325: per iteration, column 0 is
the primal render (+loss) wall-clock, column 1 the adjoint + optimizer
step (including the LinearLBFGS direction render and line search).
"""
from __future__ import annotations

import argparse
import json
import os
import time as time_mod
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..ops.render import (render, render_radon, render_corner, _adjoint,
                          default_chunk)
from .loss import losses
from .device_lbfgs import DeviceLinearLBFGS
from ..utils.io import save_img, save_vol
from ..utils.metrics import save_histogram


def _block(x):
    return jax.block_until_ready(x)


def _make_step_fns(static, arr, inv_vol, spp, spp_grad, chunk, loss_obj,
                   target, engine="auto", inside_mask=None,
                   hybrid_estimator=None):
    """Jitted primal / adjoint / direction-render / line-search closures
    for one integrator configuration.

    engine: 'auto' picks the ballistic fast path when the scene
    qualifies (collimated + analytic vial + pure absorption, see
    ops/transport2d.ballistic_eligible), the hybrid engine
    (analytic unscattered transport + MC scattered residual,
    ops/hybrid.py) for scattering scenes with precomputable geometry,
    else the wavefront MC path tracer; 'wavefront'/'ballistic'/'hybrid'
    force one."""
    from ..ops.ballistic import BallisticEngine, ballistic_eligible
    from ..ops.hybrid import ScatteringEngine, hybrid_eligible

    use_ballistic = (engine == "ballistic") or \
        (engine == "auto" and ballistic_eligible(static))
    use_hybrid = (engine == "hybrid") or \
        (engine == "auto" and not use_ballistic and
         hybrid_eligible(static))

    # Large arrays (transport fields, scene arrays, target volume,
    # surface-aware inv_vol) are passed as jit ARGUMENTS, not captured
    # as closure constants: constants are baked into the compiled
    # executable, which bloats it by O(angles x film^2).
    if use_ballistic:
        eng = BallisticEngine(static, arr, inside_mask=inside_mask)
        print(f"Engine: ballistic (backprojection {eng.impl}, transport "
              f"{eng.transport_builder})")
        ep = eng.params()

        @jax.jit
        def primal_j(data, seed, ep, iv, tgt):
            vol = eng.render_vol(data, iv, params=ep)
            loss = loss_obj(vol, tgt, data)
            return vol, loss

        @jax.jit
        def adjoint_j(vol, data, seed, ep, iv, tgt):
            dvol, dpat = jax.grad(
                lambda v, p: loss_obj(v, tgt, p),
                argnums=(0, 1))(vol, data)
            return eng.pattern_grad(dvol, iv, params=ep) + dpat

        @jax.jit
        def dir_render_j(data, seed, ep, iv):
            return eng.render_vol(data, iv, params=ep)

        primal = lambda data, seed: primal_j(data, seed, ep, inv_vol,
                                             target)
        adjoint = lambda vol, data, seed: adjoint_j(vol, data, seed, ep,
                                                    inv_vol, target)
        dir_render = lambda data, seed: dir_render_j(data, seed, ep,
                                                     inv_vol)

        def dir_fn(z, seed, ctx, iv, tgt):
            return dir_render_j(z, seed, ctx, iv)

        step_args = lambda seed: (seed, ep, inv_vol, target)
    elif use_hybrid:
        eng = ScatteringEngine(static, arr, spp=spp, spp_grad=spp_grad,
                               chunk=chunk, inside_mask=inside_mask,
                               estimator=hybrid_estimator)
        print(f"Engine: hybrid (backprojection {eng.ball.impl}, transport "
              f"{eng.ball.transport_builder}; residual "
              f"{eng.static_s.sensor.estimator})")
        ep = eng.params()

        @jax.jit
        def primal_j(data, seed, ep, iv, tgt):
            vol = eng.render_vol(data, iv, seed=seed, params=ep)
            loss = loss_obj(vol, tgt, data)
            return vol, loss

        @jax.jit
        def adjoint_j(vol, data, seed, ep, iv, tgt):
            dvol, dpat = jax.grad(
                lambda v, p: loss_obj(v, tgt, p),
                argnums=(0, 1))(vol, data)
            return eng.pattern_grad(dvol, iv, seed=seed,
                                    params=ep) + dpat

        @jax.jit
        def dir_render_j(data, seed, ep, iv):
            return eng.render_vol(data, iv, seed=seed, params=ep)

        primal = lambda data, seed: primal_j(data, seed, ep, inv_vol,
                                             target)
        adjoint = lambda vol, data, seed: adjoint_j(vol, data, seed, ep,
                                                    inv_vol, target)
        dir_render = lambda data, seed: dir_render_j(data, seed, ep,
                                                     inv_vol)

        def dir_fn(z, seed, ctx, iv, tgt):
            return dir_render_j(z, seed, ctx, iv)

        step_args = lambda seed: (seed, ep, inv_vol, target)
    else:
        print(f"Engine: wavefront ({static.sensor.estimator})")

        @partial(jax.jit, static_argnames=())
        def primal_j(data, seed, arr_, iv, tgt):
            vol = render(static, arr_, data, iv, seed, spp, spp_grad,
                         chunk)
            loss = loss_obj(vol, tgt, data)
            return vol, loss

        @jax.jit
        def adjoint_j(vol, data, seed, arr_, iv, tgt):
            dvol, dpat = jax.grad(
                lambda v, p: loss_obj(v, tgt, p),
                argnums=(0, 1))(vol, data)
            # δL into the raw accumulator = upstream * inv_vol
            # (volume.py:130)
            dL_flat = (dvol * iv).reshape(-1)
            pg, _, _ = _adjoint(static, arr_, seed, spp_grad, chunk,
                                dL_flat)
            return pg + dpat

        @jax.jit
        def dir_render_j(data, seed, arr_, iv):
            return render(static, arr_, data, iv, seed, spp, spp_grad,
                          chunk)

        primal = lambda data, seed: primal_j(data, seed, arr, inv_vol,
                                             target)
        adjoint = lambda vol, data, seed: adjoint_j(vol, data, seed, arr,
                                                    inv_vol, target)
        dir_render = lambda data, seed: dir_render_j(data, seed, arr,
                                                     inv_vol)

        def dir_fn(z, seed, ctx, iv, tgt):
            return dir_render_j(z, seed, ctx, iv)

        step_args = lambda seed: (seed, arr, inv_vol, target)

    @jax.jit
    def ls_loss_j(vol, pats, tgt):
        return loss_obj(vol, tgt, pats)

    ls_loss = lambda vol, pats: ls_loss_j(vol, pats, target)

    @jax.jit
    def ls_cand_j(vol, dvol, alpha, pats, tgt):
        return loss_obj(vol + alpha * dvol, tgt, pats)

    ls_cand = lambda vol, dvol, alpha, pats: ls_cand_j(
        vol, dvol, jnp.float32(alpha), pats, target)

    def cand_fn(vol, dvol, alpha, z, seed, ctx, iv, tgt):
        # the sparsity term rides on the SEARCH DIRECTION during the
        # line search (reference quirk, lbfgs.py:239-246)
        return loss_obj(vol + alpha * dvol, tgt, z)

    return {"primal": primal, "adjoint": adjoint,
            "dir_render": dir_render, "ls_loss": ls_loss,
            "ls_cand": ls_cand, "dir_fn": dir_fn, "cand_fn": cand_fn,
            "step_args": step_args}


def optimize(config, patterns_fwd=None, resolve_path=None):
    """Optimize projector patterns for the configured TVAM scene.

    Args:
        config: configuration dict (same JSON schema as the reference,
            docs/src/basic_usage.rst).
        patterns_fwd: if given, skip optimization and just forward-
            project these patterns (reference --forward_mode).
        resolve_path: optional relative-path resolver.
    Returns the final dose volume as a numpy (Z, Y, X, 1) array.
    """
    config = dict(config)
    if resolve_path is None:
        resolve_path = lambda p: p
    scene = Scene(config, resolve_path)
    output = config["output"]
    os.makedirs(os.path.join(output, "patterns"), exist_ok=True)

    # Rendering parameters (optimize.py:94-106)
    spp = config.get("spp", 4)
    spp_ref = config.get("spp_ref", 16)
    spp_grad = config.get("spp_grad", spp)
    max_depth = config.get("max_depth", 6)
    rr_depth = config.get("rr_depth", 6)
    print_time = config.get("time", 1.0)
    progressive = config.get("progressive", False)
    transmission_only = config.get("transmission_only", True)
    regular_sampling = config.get("regular_sampling", False)
    chunk = config.get("chunk_size", default_chunk())
    engine = config.get("engine", "auto")
    if regular_sampling:
        spp = 1  # shooting from pixel centers (common.py:52-55)

    sensor = scene.sensor
    final_sensor = scene.final_sensor
    surface_aware = sensor.surface_aware

    # Medium calibration (reference volume.py:277-280 exposes sigma_t /
    # sigma_s gradients through its adjoint; here a config key drives
    # them): "optimize_medium": {"lr": 0.05, "sigma_t": true,
    # "albedo": false}. Needs the wavefront engine — the ballistic /
    # hybrid fast paths bake the medium into precomputed transport
    # fields, so their medium partials are not available.
    med_cfg = config.get("optimize_medium", None)
    if med_cfg is True:
        med_cfg = {}
    elif not med_cfg:  # false / null / {} all disable calibration
        med_cfg = None
    if med_cfg is not None:
        if engine in ("ballistic", "hybrid"):
            raise ValueError(
                "optimize_medium requires the wavefront engine; the "
                f"'{engine}' engine precomputes the medium into its "
                "transport fields")
        engine = "wavefront"

    if sensor.static.estimator == "delta" and scene.medium.albedo == 0.0:
        raise ValueError(
            "the delta-tracking estimator needs a scattering medium "
            "(albedo > 0); use 'dda' or 'ratio' for pure absorption")

    # Reference target volume (optimize.py:131-140); alternatively a
    # recorded dose volume for medium calibration (target.dose_npy)
    if scene.target_dose is not None:
        if surface_aware:
            raise ValueError("a dose-volume target cannot drive the "
                             "surface-aware discretization")
        if config.get("filter_radon", False) or "filter_corner" in config:
            raise ValueError("DMD-pixel culling filters need a target "
                             "mesh, not a dose volume")
        tb = None
        target = scene.target_dose
    else:
        tb = scene.target_bank()
        if surface_aware:
            target = np.asarray(sensor.compute_volume(tb))
            save_vol(target[..., 0, None],
                     os.path.join(output, "target_in.exr"))
            save_vol(target[..., 1, None],
                     os.path.join(output, "target_out.exr"))
        else:
            target = np.asarray(sensor.discretize(tb))
            save_vol(target, os.path.join(output, "target.exr"))
    np.save(os.path.join(output, "target.npy"), target)
    target = jnp.asarray(target)

    # ---- DMD pixel culling (optimize.py:143-185) -------------------------
    if config.get("filter_radon", False) and patterns_fwd is None:
        from ..ops.transport2d import unscattered_eligible
        static_v, arr_v = scene.build(
            mode="volume", include_target=False, max_depth=5,
            rr_depth=rr_depth, print_time=1.0,
            transmission_only=transmission_only,
            regular_sampling=regular_sampling)
        if unscattered_eligible(static_v):
            # transport-eligible scene: the radon>0 test is one
            # transpose matmul of the target occupancy (see
            # ops/ballistic.radon_active_ballistic) — same kept-pixel
            # set as the reference's radon render, ~1000x cheaper
            from ..ops.ballistic import radon_active_ballistic
            cull_mask = target if not surface_aware \
                else np.asarray(sensor.discretize(tb))
            active = radon_active_ballistic(static_v, arr_v, cull_mask)
        else:
            static_r, arr_r = scene.build(
                mode="radon", include_target=True, max_depth=5,
                rr_depth=rr_depth, print_time=1.0,
                transmission_only=transmission_only,
                regular_sampling=regular_sampling)
            img = np.asarray(_block(render_radon(
                static_r, arr_r, seed=0,
                spp=config.get("spp_filter_radon", 4), chunk=chunk)))
            active = np.nonzero(img > 0.0)[0].astype(np.int32)
        if active.size == 0:
            raise ValueError(
                "Radon culling removed every DMD pixel — no ray ever "
                "crosses the target. Check the projector/target setup.")
        scene.projector.set_active(active, np.zeros(active.size, np.float32))

    if "filter_corner" in config and patterns_fwd is None:
        ccfg = config["filter_corner"]
        static_c, arr_c = scene.build(
            mode="volume", include_target=True, max_depth=1,
            rr_depth=rr_depth, print_time=1.0,
            transmission_only=transmission_only, regular_sampling=True)
        img = np.asarray(_block(render_corner(
            static_c, arr_c, dist=ccfg["dist"],
            radius=ccfg.get("radius", 0.1), seed=0, chunk=chunk)))
        active = np.nonzero(img > 0.0)[0].astype(np.int32)
        if active.size == 0:
            raise ValueError(
                "Corner culling removed every DMD pixel — the corner "
                "radius/dist likely cover the whole aperture.")
        scene.projector.set_active(active, np.zeros(active.size, np.float32))

    # ---- loss / optimizer selection (optimize.py:193-222) ----------------
    if "loss" not in config:
        print("Config has no 'loss' entry; defaulting to the thresholded "
              "dose loss.")
        config["loss"] = {"type": "threshold"}
    loss_cfg = dict(config["loss"])
    loss_type = loss_cfg.pop("type")
    if loss_type not in losses:
        raise ValueError(f"no loss named '{loss_type}' is registered "
                         f"(have: {sorted(losses)})")
    loss_obj = losses[loss_type](loss_cfg)

    if "optimizer" not in config:
        print("Config has no 'optimizer' entry; defaulting to linear "
              "L-BFGS.")
        config["optimizer"] = {"type": "lbfgs"}
    opt_cfg = dict(config["optimizer"])
    optim_type = opt_cfg.pop("type")

    n_steps = config.get("n_steps", 40)
    loss_hist = np.zeros(n_steps)
    timing_hist = np.zeros((n_steps, 2))

    # final integrator config (optimize.py:231-238)
    max_depth_ref = config.get("max_depth_ref", 16)
    rr_depth_ref = config.get("rr_depth_ref", 8)

    def final_render(data):
        from ..ops.ballistic import BallisticEngine, ballistic_eligible
        from ..ops.hybrid import ScatteringEngine, hybrid_eligible
        static_f, arr_f = scene.build(
            mode="volume", include_target=surface_aware,
            max_depth=max_depth_ref, rr_depth=rr_depth_ref,
            print_time=print_time, transmission_only=transmission_only,
            regular_sampling=regular_sampling, sensor=final_sensor)
        inv_vol_f = jnp.float32(1.0 / final_sensor.voxel_volume)
        mask_f = final_sensor.discretize(tb) if surface_aware else None
        if engine != "wavefront" and ballistic_eligible(static_f):
            eng = BallisticEngine(static_f, arr_f, inside_mask=mask_f)
            return np.asarray(_block(eng.render_vol(data, inv_vol_f)))
        if engine != "wavefront" and hybrid_eligible(static_f):
            eng = ScatteringEngine(static_f, arr_f, spp=spp_ref,
                                   chunk=chunk, inside_mask=mask_f)
            return np.asarray(_block(eng.render_vol(data, inv_vol_f,
                                                    seed=0)))
        return np.asarray(_block(render(
            static_f, arr_f, data, inv_vol_f, seed=0, spp=spp_ref,
            chunk=chunk)))

    def dump_patterns(data):
        imgs = np.asarray(scene.projector.patterns(data))
        print("Writing per-pattern EXR images...")
        for i in range(imgs.shape[0]):
            save_img(imgs[i], os.path.join(output, "patterns",
                                           f"{i:04d}.exr"))
        np.savez_compressed(os.path.join(output, "patterns.npz"),
                            patterns=imgs)
        return imgs

    # ---- forward-only / PSF modes (optimize.py:240-284) ------------------
    if patterns_fwd is not None:
        print("Forward mode: projecting the supplied patterns, no "
              "optimization.")
        data = jnp.asarray(np.asarray(patterns_fwd, np.float32).ravel())
        scene.projector.active_data = data
    elif "psf_analysis" in config:
        entries = config["psf_analysis"]
        print(f"\nPSF analysis mode: tracing {len(entries)} isolated "
              "DMD pixels.")
        xres = config["projector"]["resx"]
        yres = config["projector"]["resy"]
        pix = np.zeros(len(entries), np.int32)
        val = np.ones(len(entries), np.float32)
        for i, e in enumerate(entries):
            if e["x"] >= xres or e["y"] >= yres:
                raise ValueError(
                    f"psf_analysis pixel ({e['x']}, {e['y']}) lies outside "
                    f"the {xres}x{yres} DMD")
            if e["index_pattern"] >= config["projector"]["n_patterns"]:
                raise ValueError(
                    f"psf_analysis index_pattern {e['index_pattern']} "
                    "exceeds n_patterns")
            pix[i] = xres * yres * e["index_pattern"] + xres * e["y"] + e["x"]
            val[i] = e["intensity"]
        scene.projector.set_active(pix, val)
        data = scene.projector.active_data

        print("Rendering the final dose volume...")
        vol_final = final_render(data)
        np.save(os.path.join(output, "final.npy"), vol_final)
        save_vol(vol_final, os.path.join(output, "final.exr"))
        np.save(os.path.join(output, "loss.npy"), loss_hist)
        np.save(os.path.join(output, "timing.npy"), timing_hist)
        dump_patterns(data)
        return vol_final
    else:
        # ---- the optimization loop (optimize.py:287-325) -----------------
        print("Starting the pattern optimization loop...")
        data = scene.projector.active_data
        checkpoint_every = int(config.get("checkpoint_every", 0))
        resume_ckpt = None
        if config.get("resume", False):
            from .checkpoint import load_checkpoint
            resume_ckpt = load_checkpoint(output)
            if resume_ckpt is None:
                print("No checkpoint found; starting from scratch.")

        def build_fns(depth):
            import dataclasses
            static, arr = scene.build(
                mode="volume", include_target=surface_aware,
                max_depth=depth, rr_depth=rr_depth, print_time=print_time,
                transmission_only=transmission_only,
                regular_sampling=regular_sampling)
            if med_cfg is not None:
                static = dataclasses.replace(static, medium_grads=True)
            inv_vol = sensor.inv_volume(tb if surface_aware else None)
            mask = sensor.discretize(tb) if surface_aware else None
            fns = _make_step_fns(static, arr, inv_vol, spp, spp_grad,
                                 chunk, loss_obj, target, engine, mask,
                                 config.get("hybrid_estimator"))
            if med_cfg is not None:
                @jax.jit
                def medium_grad_j(data, seed, arr_, iv, tgt, st, al):
                    def f(st_, al_):
                        a2 = dict(arr_)
                        a2["sigma_t"] = st_
                        a2["albedo"] = al_
                        vol = render(static, a2, data, iv, seed, spp,
                                     spp_grad, chunk)
                        return loss_obj(vol, tgt, data)
                    return jax.grad(f, argnums=(0, 1))(st, al)

                fns["medium_grad"] = lambda data, seed, st, al: \
                    medium_grad_j(data, seed, arr, inv_vol, target,
                                  st, al)
                fns["arr"] = arr
            return fns

        fns = build_fns(3 if progressive else max_depth)

        med_params = None
        if med_cfg is not None:
            import optax
            med_tx = optax.adam(float(med_cfg.get("lr", 0.01)))
            med_params = {"st": jnp.float32(scene.medium.sigma_t),
                          "al": jnp.float32(scene.medium.albedo)}
            med_state = med_tx.init(med_params)
            med_opt_st = bool(med_cfg.get("sigma_t", True))
            med_opt_al = bool(med_cfg.get("albedo", False)) and \
                scene.medium.albedo > 0.0

            def apply_medium(fns):
                fns["arr"]["sigma_t"] = np.float32(med_params["st"])
                fns["arr"]["albedo"] = np.float32(med_params["al"])

        opt = None
        opt_state = None
        if optim_type == "lbfgs":
            # device-resident L-BFGS: history update + direction render
            # + Armijo search run as ONE dispatch per iteration (the
            # host LinearLBFGS costs ~25 blocking syncs per step)
            opt = DeviceLinearLBFGS(dir_fn=fns["dir_fn"],
                                    cand_fn=fns["cand_fn"], **opt_cfg)
        elif optim_type in ("adam", "sgd"):
            import optax
            lr = opt_cfg.pop("lr", 0.01 if optim_type == "adam" else 0.1)
            if optim_type == "adam":
                tx = optax.adam(lr, **opt_cfg)
            else:
                tx = optax.sgd(lr, **opt_cfg)
            opt_state = tx.init(data)
        else:
            raise ValueError(f"Unknown optimizer type: '{optim_type}'")

        # optional device profiling (SURVEY.md §5: the reference records
        # Dr.Jit kernel history; here a jax.profiler trace on request)
        profile_dir = config.get("profile", False)
        if profile_dir:
            profile_dir = os.path.join(output, "trace") \
                if profile_dir is True or profile_dir == "true" \
                else str(profile_dir)
            jax.profiler.start_trace(profile_dir)
            print(f"Profiling to {profile_dir}")

        start_step = 0
        if resume_ckpt is not None:
            from .checkpoint import restore_opt_state
            start_step = int(resume_ckpt["step"]) + 1
            data = jnp.asarray(resume_ckpt["active_data"])
            scene.projector.set_active(resume_ckpt["active_pixels"],
                                       resume_ckpt["active_data"])
            n_saved = min(len(resume_ckpt["loss_hist"]), n_steps)
            loss_hist[:n_saved] = resume_ckpt["loss_hist"][:n_saved]
            timing_hist[:n_saved] = resume_ckpt["timing_hist"][:n_saved]
            new_state = restore_opt_state(resume_ckpt, optim_type, opt,
                                          opt_state)
            if new_state is not None:
                opt_state = new_state
            if med_params is not None:
                from .checkpoint import restore_med_state
                med = restore_med_state(resume_ckpt, med_state)
                if med is not None:
                    med_params, med_state = med
                    apply_medium(fns)
            if progressive and start_step >= 5:
                fns = build_fns(max_depth)
                if opt is not None:
                    opt.rebind(fns["dir_fn"], fns["cand_fn"])
            print(f"Resuming from checkpoint at step {start_step}.")

        for i in range(start_step, n_steps):
            if progressive and i == 5:
                fns = build_fns(max_depth)
                if opt is not None:
                    opt.rebind(fns["dir_fn"], fns["cand_fn"])
                if med_params is not None:
                    apply_medium(fns)
            seed = jnp.uint32(i)

            t0 = time_mod.perf_counter()
            vol, loss = _block(fns["primal"](data, seed))
            timing_hist[i, 0] = time_mod.perf_counter() - t0
            loss_hist[i] = float(loss)

            t1 = time_mod.perf_counter()
            grad = _block(fns["adjoint"](vol, data, seed))

            if loss_hist[i] == 0.0:
                print("Converged")
                timing_hist[i, 1] = time_mod.perf_counter() - t1
                break

            if optim_type == "lbfgs":
                # one dispatch: direction + line search + clamp on device
                data = _block(opt.step(data, grad, vol, loss,
                                       step_args=fns["step_args"](seed)))
            else:
                updates, opt_state = tx.update(grad, opt_state, data)
                import optax
                data = optax.apply_updates(data, updates)
                # Clamp patterns >= 0 (optimize.py:320)
                data = _block(jnp.maximum(data, 0.0))

            if med_params is not None:
                import optax
                g_st, g_al = _block(fns["medium_grad"](
                    data, seed, med_params["st"], med_params["al"]))
                g = {"st": g_st if med_opt_st else jnp.float32(0.0),
                     "al": g_al if med_opt_al else jnp.float32(0.0)}
                updates, med_state = med_tx.update(g, med_state,
                                                   med_params)
                med_params = optax.apply_updates(med_params, updates)
                med_params["st"] = jnp.clip(med_params["st"], 1e-5, None)
                # keep albedo exactly 0 for non-scattering media — a
                # positive floor would flip the final render into the
                # scattering path without a configured phase function
                med_params["al"] = jnp.clip(med_params["al"], 0.0, 0.999)
                apply_medium(fns)
            timing_hist[i, 1] = time_mod.perf_counter() - t1
            print(f"step {i + 1}/{n_steps}: loss {loss_hist[i]:.6e} "
                  f"({timing_hist[i].sum():.3f} s)", flush=True)

            if checkpoint_every and ((i + 1) % checkpoint_every == 0
                                     or i == n_steps - 1):
                from .checkpoint import save_checkpoint
                save_checkpoint(output, i, data,
                                scene.projector.active_pixels, loss_hist,
                                timing_hist, optim_type, opt, opt_state,
                                med_params=med_params,
                                med_state=(med_state if med_params
                                           is not None else None))

        if profile_dir:
            jax.profiler.stop_trace()
        scene.projector.active_data = data

        if med_params is not None:
            st_f = float(med_params["st"])
            al_f = float(med_params["al"])
            scene.medium.sigma_t = st_f
            scene.medium.albedo = al_f
            with open(os.path.join(output, "medium.json"), "w") as f:
                json.dump({"sigma_t": st_f, "albedo": al_f}, f, indent=2)
            print(f"Calibrated medium: sigma_t={st_f:.6f} "
                  f"albedo={al_f:.4f}")

    # ---- final render + artifacts (optimize.py:327-366) ------------------
    print("Rendering the final dose volume...")
    vol_final = final_render(data)
    np.save(os.path.join(output, "final.npy"), vol_final)
    save_vol(vol_final, os.path.join(output, "final.exr"))
    np.save(os.path.join(output, "loss.npy"), loss_hist)
    np.save(os.path.join(output, "timing.npy"), timing_hist)

    imgs = dump_patterns(data)
    array_max = float(np.max(imgs)) if imgs.size else 1.0
    array_max = array_max if array_max > 0 else 1.0
    normalized = imgs / array_max
    np.savez_compressed(
        os.path.join(output, "patterns_normalized_uint8.npz"),
        patterns=(normalized * 255).astype(np.uint8))

    if surface_aware:
        target_binary = np.asarray(final_sensor.discretize(tb))
        np.save(os.path.join(output, "target_binary.npy"), target_binary)
        save_vol(target_binary, os.path.join(output, "target_binary.exr"))
        hist_target = target_binary
    else:
        hist_target = np.asarray(target)

    efficiency = float(np.sum(normalized / normalized.size))
    print(f"Pattern energy efficiency: {efficiency:.4f}")
    best_iou, best_thr = save_histogram(
        vol_final, hist_target, os.path.join(output, "histogram.png"),
        efficiency, array_max)
    with open(os.path.join(output, "metrics.json"), "w") as f:
        json.dump({"best_iou": best_iou, "best_threshold": best_thr,
                   "normalized_threshold": best_thr / array_max,
                   "pattern_efficiency": efficiency}, f, indent=2)
    return vol_final


# --------------------------------------------------------------------------
# CLI (optimize.py:373-445)


def parse_overrides(pairs):
    """`-D a.b.c=value` strings -> {dotted_key: coerced_value}.

    Values go through json.loads, so numbers, booleans, null, and quoted
    strings all coerce naturally; anything that isn't valid JSON stays a
    plain string (e.g. `-D vial.type=square`)."""
    out = {}
    for item in pairs or []:
        key, sep, raw = item.partition("=")
        if not sep or not key:
            raise ValueError(f"override '{item}' is not of the form "
                             "key=value")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


def make_resolver(base_dir):
    def resolve(p):
        if os.path.isabs(p) or os.path.exists(p):
            return p
        cand = os.path.join(base_dir, p)
        return cand if os.path.exists(cand) else p
    return resolve


def main(argv=None):
    parser = argparse.ArgumentParser("Optimize patterns for TVAM.")
    parser.add_argument("config", type=str,
                        help="Path to the configuration file")
    parser.add_argument("-D", dest="overrides", metavar="key=value",
                        action="append", default=[],
                        help="Override/Add a parameter in the configuration "
                        "dictionary. Nested keys are separated by dots.")
    parser.add_argument("--backend", type=str, default=None,
                        choices=["cpu", "gpu"],
                        help="Select the JAX platform for the optimization.")
    parser.add_argument("--forward_mode", action="store_true",
                        help="Just project the patterns without optimization."
                        " Patterns need to be specified by --patterns (a "
                        ".npz file).")
    parser.add_argument("--patterns", type=str,
                        help="Path to the patterns file (a .npz file). This "
                        "is only used in forward mode.")
    args = parser.parse_args(argv)

    if args.backend is not None:
        jax.config.update("jax_platforms", args.backend)
    from ..utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    print(f"JAX devices: {len(devs)} x {devs[0].device_kind} "
          f"({devs[0].platform})")

    with open(args.config, "r") as f:
        config = json.load(f)

    if args.overrides:
        for key, value in parse_overrides(args.overrides).items():
            key = key.split(".")
            tmp = config
            for k in key[:-1]:
                tmp = tmp[k]
            tmp[key[-1]] = value

    base_dir = os.path.dirname(os.path.abspath(args.config))
    if "output" not in config:
        config["output"] = base_dir

    os.makedirs(os.path.join(config["output"], "patterns"), exist_ok=True)
    with open(os.path.join(config["output"], "opt_config.json"), "w") as f:
        json.dump(config, f, indent=4)

    if args.forward_mode:
        if args.patterns is None:
            raise ValueError(
                "--forward_mode needs --patterns pointing at a .npz file")
        patterns = np.load(args.patterns)["patterns"]
        optimize(config, patterns_fwd=patterns,
                 resolve_path=make_resolver(base_dir))
    else:
        optimize(config, resolve_path=make_resolver(base_dir))


if __name__ == "__main__":
    main()

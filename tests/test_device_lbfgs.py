"""Device-resident Linear L-BFGS must reproduce the host loop.

The host `LinearLBFGS` (opt/lbfgs.py) is the reference-parity
implementation; `fused_linear_lbfgs` / `DeviceLinearLBFGS` rerun the
identical algorithm without host syncs.

Component contracts are exact: the two-loop direction matches the host
recursion to f32 round-off on identical history, and the Armijo search
picks the identical (discrete) step size. Full trajectories are chaotic
in f32 — XLA fuses/reorders the reductions inside the while_loop — so
they are compared loosely: same early steps, same convergence level.
"""
import jax
import jax.numpy as jnp
import numpy as np

from drtvam_tpu.opt.lbfgs import LinearLBFGS, _LBFGSHistory
from drtvam_tpu.opt.device_lbfgs import (fused_linear_lbfgs,
                                         DeviceLinearLBFGS,
                                         lbfgs_direction, armijo_search)
from drtvam_tpu.opt.loss import ThresholdedLoss


def _problem(seed=0, n=48, k=160, n_steps=12):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.uniform(0.0, 0.2, (k, n)).astype(np.float32))
    target = jnp.asarray((rng.uniform(size=(k, 1, 1, 1)) > 0.6)
                         .astype(np.float32))
    loss_obj = ThresholdedLoss({"tl": 0.8, "tu": 0.9,
                                "weight_sparsity": 1e-3})

    def render(p):
        return (A @ p).reshape(k, 1, 1, 1)

    def loss_fn(vol, pats):
        return loss_obj(vol, target, pats)

    p0 = jnp.ones((n,), jnp.float32)
    return render, loss_fn, p0, n_steps


def _host_trajectory(render, loss_fn, p0, n_steps):
    opt = LinearLBFGS(render_fn=render, loss_fn=loss_fn)
    p = p0
    losses = []
    for i in range(n_steps):
        vol = render(p)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        losses.append(float(loss))
        if losses[-1] == 0.0:
            break
        p = opt.step(p, grad, vol, loss)
        p = jnp.maximum(p, 0.0)
    return np.asarray(p), np.asarray(losses)


def test_direction_matches_host_recursion():
    """Two-loop recursion on identical history: f32 round-off only."""
    rng = np.random.default_rng(11)
    n, m = 64, 5
    host = _LBFGSHistory(m=m)
    for t in range(7):  # more updates than slots -> exercises eviction
        p = jnp.asarray(rng.normal(size=n).astype(np.float32))
        g = jnp.asarray(rng.normal(size=n).astype(np.float32))
        host.update_history(p, g)
    g_q = jnp.asarray(rng.normal(size=n).astype(np.float32))
    z_host = np.asarray(host.search_direction(g_q))

    nh = len(host.s)
    S = jnp.zeros((m, n), jnp.float32)
    Yh = jnp.zeros((m, n), jnp.float32)
    ys = jnp.ones((m,), jnp.float32)
    # host keeps oldest-first lists; circular buffer inserts in order
    for i in range(nh):
        slot = i % m
        S = S.at[slot].set(host.s[i])
        Yh = Yh.at[slot].set(host.y[i])
        ys = ys.at[slot].set(host.ys[i])
    z_dev = np.asarray(lbfgs_direction(
        g_q, S, Yh, ys, jnp.int32(nh % m), jnp.int32(nh), m))
    np.testing.assert_allclose(z_dev, z_host, rtol=1e-5, atol=1e-6)


def test_armijo_picks_identical_alpha():
    """The halving search is discrete: device alpha == host alpha."""
    render, loss_fn, p0, _ = _problem(seed=5)
    vol = render(p0)
    loss = loss_fn(vol, p0)
    grad = jax.grad(lambda q: loss_fn(render(q), q))(p0)
    z = -grad
    dvol = render(z)
    g_dot_z = float(jnp.dot(grad, z))

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    # host loop (lbfgs.py:172-179 semantics)
    alpha_host, c1 = 1.0, 1e-4
    for _ in range(20):
        f_new = float(cand(vol, dvol, alpha_host, z))
        if f_new <= float(loss) + c1 * alpha_host * g_dot_z:
            break
        alpha_host *= 0.5

    alpha_dev = float(jax.jit(lambda: armijo_search(
        cand, vol, dvol, z, loss, jnp.float32(g_dot_z)))())
    assert alpha_dev == alpha_host


def test_fused_matches_host_trajectory():
    render, loss_fn, p0, n_steps = _problem()
    p_host, losses_host = _host_trajectory(render, loss_fn, p0, n_steps)

    def value_grad(p):
        vol = render(p)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        return vol, loss, grad

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    run = jax.jit(lambda p: fused_linear_lbfgs(
        value_grad, render, cand, p, n_steps))
    p_dev, loss_hist, n_done = jax.block_until_ready(run(p0))
    loss_hist = np.asarray(loss_hist)

    assert int(n_done) == len(losses_host)
    # first two steps run on bit-identical state
    np.testing.assert_allclose(loss_hist[:2], losses_host[:2], rtol=1e-5)
    # afterwards f32 reduction-order drift compounds; require the same
    # convergence behavior, not bitwise paths
    np.testing.assert_allclose(loss_hist[2:len(losses_host)],
                               losses_host[2:], rtol=0.05)
    assert abs(loss_hist[len(losses_host) - 1] - losses_host[-1]) <= \
        0.05 * abs(losses_host[-1])


def test_steppable_matches_host_trajectory():
    render, loss_fn, p0, n_steps = _problem(seed=3)
    p_host, losses_host = _host_trajectory(render, loss_fn, p0, n_steps)

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    opt = DeviceLinearLBFGS(dir_fn=lambda z: render(z), cand_fn=cand)

    @jax.jit
    def primal(p):
        vol = render(p)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        return vol, loss, grad

    p = p0
    losses = []
    for i in range(n_steps):
        vol, loss, grad = primal(p)
        losses.append(float(loss))
        if losses[-1] == 0.0:
            break
        p = opt.step(p, grad, vol, loss)

    np.testing.assert_allclose(np.asarray(losses[:2]), losses_host[:2],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(losses[2:]), losses_host[2:],
                               rtol=0.05)


def test_bf16_history_converges_like_f32():
    """bfloat16 S/Yh storage (the configuration bench.py uses at 64M
    patterns) perturbs the quasi-Newton direction but
    must not change the convergence level: same final loss within 10%
    and monotone-ish descent."""
    render, loss_fn, p0, n_steps = _problem(seed=9, n_steps=12)

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    @jax.jit
    def primal(p):
        vol = render(p)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        return vol, loss, grad

    def run(opt):
        p = p0
        losses = []
        for i in range(n_steps):
            vol, loss, grad = primal(p)
            losses.append(float(loss))
            p = opt.step(p, grad, vol, loss)
        return losses

    losses_f32 = run(DeviceLinearLBFGS(dir_fn=render, cand_fn=cand))
    opt16 = DeviceLinearLBFGS(dir_fn=render, cand_fn=cand,
                              history_dtype=jnp.bfloat16)
    losses_bf16 = run(opt16)
    assert opt16._state["S"].dtype == jnp.bfloat16
    assert losses_bf16[-1] <= losses_f32[-1] * 1.10 + 1e-12
    assert losses_bf16[-1] < losses_bf16[0] * 0.5  # actually descended


def test_checkpoint_roundtrip():
    render, loss_fn, p0, n_steps = _problem(seed=7, n_steps=8)

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    @jax.jit
    def primal(p):
        vol = render(p)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        return vol, loss, grad

    def run(opt, p, lo, hi):
        for i in range(lo, hi):
            vol, loss, grad = primal(p)
            p = opt.step(p, grad, vol, loss)
        return p

    opt_a = DeviceLinearLBFGS(dir_fn=lambda z: render(z), cand_fn=cand)
    p_full = run(opt_a, p0, 0, 8)

    opt_b = DeviceLinearLBFGS(dir_fn=lambda z: render(z), cand_fn=cand)
    p_half = run(opt_b, p0, 0, 4)
    state = opt_b.state_dict()

    opt_c = DeviceLinearLBFGS(dir_fn=lambda z: render(z), cand_fn=cand)
    opt_c.load_state_dict(state)
    p_resumed = run(opt_c, p_half, 4, 8)

    np.testing.assert_allclose(np.asarray(p_resumed), np.asarray(p_full),
                               rtol=1e-5, atol=1e-6)


def test_fused_segmented_matches_one_shot():
    """Segmented execution (state/stop_i/return_state) with pass_iter
    and bf16 history must reproduce the one-shot fused run exactly:
    the loop carry round-trips through the host untouched and stop_i
    only caps the while condition."""
    render, loss_fn, p0, n_steps = _problem()

    def value_grad(p, i):
        # fold the iteration index in like a per-step MC seed would be
        vol = render(p) * (1.0 + 0.0 * i)
        loss = loss_fn(vol, p)
        grad = jax.grad(lambda q: loss_fn(render(q), q))(p)
        return vol, loss, grad

    def dir_fn(z, i):
        return render(z)

    def cand(vol, dvol, alpha, z):
        return loss_fn(vol + alpha * dvol, z)

    kw = dict(history_dtype=jnp.bfloat16, pass_iter=True)
    one = jax.jit(lambda p: fused_linear_lbfgs(
        value_grad, dir_fn, cand, p, n_steps, **kw))
    p_one, hist_one, done_one = jax.block_until_ready(one(p0))

    seg = jax.jit(lambda st, stop, p: fused_linear_lbfgs(
        value_grad, dir_fn, cand, p, n_steps, state=st, stop_i=stop,
        return_state=True, **kw))
    state = None
    p_seg = p0
    for stop in (2, 5, n_steps):
        if state is None:
            p_seg, hist_seg, done_seg, state = jax.block_until_ready(
                jax.jit(lambda p, stop: fused_linear_lbfgs(
                    value_grad, dir_fn, cand, p, n_steps,
                    stop_i=stop, return_state=True, **kw))(
                        p0, jnp.int32(stop)))
        else:
            p_seg, hist_seg, done_seg, state = jax.block_until_ready(
                seg(state, jnp.int32(stop), p0))

    assert int(done_seg) == int(done_one)
    np.testing.assert_array_equal(np.asarray(p_seg), np.asarray(p_one))
    np.testing.assert_array_equal(np.asarray(hist_seg),
                                  np.asarray(hist_one))

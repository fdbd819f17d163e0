"""Device-resident Linear L-BFGS: the whole optimization loop inside jit.

The host-side `LinearLBFGS` (opt/lbfgs.py) mirrors the reference's
control flow (lbfgs.py:146-275) but syncs scalars to the host for the
history update and every Armijo trial — up to ~25 device round-trips
per iteration. Each blocking call stalls the device, which dominates
the optimization loop when the renders themselves are fast (the
ballistic engine).

`fused_linear_lbfgs` runs the identical algorithm entirely on device:
fixed-size circular history buffers, the two-loop recursion as an
unrolled masked loop over the m slots, and the Armijo halving search
as a `lax.while_loop`. A full n-step optimization is ONE dispatch.

Semantics matched to opt/lbfgs.py (which matches the reference):
  * history acceptance: ys > 1e-10 * max(|y|*|s|, 1e-30), finite;
  * gamma scaling from the newest pair; m = 5 default;
  * Armijo c1 = 1e-4, alpha halving, `search_it` trials, the alpha
    after a failed final trial is still halved (lbfgs.py:256-266);
  * the sparsity term of the loss is evaluated on the SEARCH DIRECTION
    during the line search (reference quirk, lbfgs.py:239-246);
  * patterns clamped >= 0 after the step (optimize.py:320);
  * loop breaks once the loss hits exactly 0 (optimize.py:310-312).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _dot(a, b):
    """f32 inner product at full precision (no TF32 rounding)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _insert_row(M, row, slot, accept):
    """M[slot] = row if accept else M[slot] (shape-stable)."""
    cur = jax.lax.dynamic_slice_in_dim(M, slot, 1, 0)
    new = jnp.where(accept, row[None], cur)
    return jax.lax.dynamic_update_slice_in_dim(M, new, slot, 0)


def _row(M, slot):
    return jax.lax.dynamic_slice_in_dim(M, slot, 1, 0)[0]


def lbfgs_direction(g, S, Yh, ys, head, nvalid, m):
    """Two-loop recursion over the circular (m, n) history buffers.

    Slot k (0 = newest) lives at (head - 1 - k) mod m; slots with
    k >= nvalid are masked out. Matches opt/lbfgs.py search_direction.
    """
    q = g
    alphas = jnp.zeros((m,), jnp.float32)
    for k in range(m):
        slot = (head - 1 - k) % m
        ok = k < nvalid
        sk = _row(S, slot).astype(jnp.float32)
        yk = _row(Yh, slot).astype(jnp.float32)
        a = _dot(sk, q) / ys[slot]
        a = jnp.where(ok, a, 0.0)
        q = jnp.where(ok, q - a * yk, q)
        alphas = alphas.at[k].set(a)
    newest = (head - 1) % m
    y_new = _row(Yh, newest).astype(jnp.float32)
    gamma = jnp.where(
        nvalid > 0,
        ys[newest] / jnp.maximum(_dot(y_new, y_new), 1e-30),
        1.0)
    z = gamma * q
    for k in range(m - 1, -1, -1):
        slot = (head - 1 - k) % m
        ok = k < nvalid
        sk = _row(S, slot).astype(jnp.float32)
        yk = _row(Yh, slot).astype(jnp.float32)
        b = _dot(yk, z) / ys[slot]
        z = jnp.where(ok, z + (alphas[k] - b) * sk, z)
    return -z


def armijo_search(cand_fn, vol, dvol, z, loss, g_dot_z,
                  search_it=20, c1=1e-4):
    """Device-side Armijo halving search (lbfgs.py:256-266).

    cand_fn(vol, dvol, alpha, z) -> candidate loss. Returns alpha.
    """
    def cond(c):
        alpha, ok, j = c
        return (j < search_it) & ~ok

    def body(c):
        alpha, ok, j = c
        f_new = cand_fn(vol, dvol, alpha, z)
        ok = f_new <= loss + c1 * alpha * g_dot_z
        alpha = jnp.where(ok, alpha, alpha * 0.5)
        return (alpha, ok, j + 1)

    alpha, _, _ = jax.lax.while_loop(
        cond, body, (jnp.float32(1.0), jnp.bool_(False), jnp.int32(0)))
    return alpha


def fused_linear_lbfgs(value_grad_fn, dir_fn, cand_fn, p0, n_steps,
                       m=5, search_it=20, c1=1e-4, clamp=True,
                       history_dtype=jnp.float32, pass_iter=False,
                       state=None, stop_i=None, return_state=False):
    """Run the full Linear-L-BFGS loop on device; call INSIDE jit.

    Args:
        value_grad_fn: p -> (vol, loss, grad). The fused primal render +
            loss + adjoint for the current patterns. With
            pass_iter=True it is called as value_grad_fn(p, i) with the
            traced iteration index — MC renders use it as the per-step
            sampler seed (reference optimize.py:294).
        dir_fn: z -> dvol (or (z, i) -> dvol with pass_iter). Render of
            the search direction (the linearity trick, lbfgs.py:248).
        cand_fn: (vol, dvol, alpha, z) -> loss of `vol + alpha*dvol`
            with the sparsity term on z (reference quirk).
        p0: initial flat pattern vector (n,).
        n_steps: static iteration count.
        clamp: clamp patterns >= 0 after each step (optimize.py:320).
        history_dtype: storage dtype of the S/Yh circular buffers —
            bfloat16 halves the 2*(m, n) history footprint; curvature
            scalars and two-loop dot products stay f32 (see
            DeviceLinearLBFGS.__init__).

    Returns (p, loss_hist, n_done): final patterns, per-step losses
    (entries past an early break repeat the converged loss' step index
    semantics of the host loop: they stay 0), steps actually run.

    Segmented runs (`state` / `stop_i` / `return_state`): passing
    return_state=True appends the loop-carry pytree to the return
    value; feeding it back via `state` resumes exactly where the last
    call stopped (the global iteration counter — and with it the MC
    seed sequence — continues). `stop_i` (traced int) caps this call at
    iteration stop_i instead of n_steps, so a host driver can run the
    fused loop in K-iteration dispatches with wall-clock budget checks
    between them without recompiling per segment.
    """
    n = p0.shape[0]

    if state is None:
        state = dict(
            i=jnp.int32(0), done=jnp.bool_(False),
            p=p0.astype(jnp.float32),
            p_old=jnp.zeros_like(p0, jnp.float32),
            g_old=jnp.zeros_like(p0, jnp.float32),
            S=jnp.zeros((m, n), history_dtype),
            Yh=jnp.zeros((m, n), history_dtype),
            ys=jnp.ones((m,), jnp.float32),
            head=jnp.int32(0), nvalid=jnp.int32(0),
            loss_hist=jnp.zeros((n_steps,), jnp.float32),
        )

    stop = jnp.int32(n_steps) if stop_i is None else \
        jnp.minimum(jnp.asarray(stop_i, jnp.int32), n_steps)

    def cond(s):
        return (s["i"] < stop) & ~s["done"]

    def body(s):
        p = s["p"]
        if pass_iter:
            vol, loss, g = value_grad_fn(p, s["i"])
        else:
            vol, loss, g = value_grad_fn(p)
        loss_hist = s["loss_hist"].at[s["i"]].set(loss)
        done = loss == 0.0

        # -- history update (lbfgs.py:176-196 + curvature safeguard) --
        sv = p - s["p_old"]
        yv = g - s["g_old"]
        ysv = _dot(yv, sv)
        norm = jnp.linalg.norm(yv) * jnp.linalg.norm(sv)
        accept = (s["i"] > 0) & jnp.isfinite(ysv) & \
            (ysv > 1e-10 * jnp.maximum(norm, 1e-30))
        head, nvalid = s["head"], s["nvalid"]
        S = _insert_row(s["S"], sv.astype(s["S"].dtype), head, accept)
        Yh = _insert_row(s["Yh"], yv.astype(s["Yh"].dtype), head,
                         accept)
        ys = s["ys"].at[head].set(jnp.where(accept, ysv, s["ys"][head]))
        head = jnp.where(accept, (head + 1) % m, head)
        nvalid = jnp.where(accept, jnp.minimum(nvalid + 1, m), nvalid)

        z = lbfgs_direction(g, S, Yh, ys, head, nvalid, m)
        dvol = dir_fn(z, s["i"]) if pass_iter else dir_fn(z)
        g_dot_z = _dot(g, z)
        alpha = armijo_search(cand_fn, vol, dvol, z, loss, g_dot_z,
                              search_it, c1)
        p_new = p + alpha * z
        if clamp:
            p_new = jnp.maximum(p_new, 0.0)
        p_new = jnp.where(done, p, p_new)

        return dict(
            i=s["i"] + 1, done=done,
            p=p_new, p_old=p, g_old=g,
            S=S, Yh=Yh, ys=ys, head=head, nvalid=nvalid,
            loss_hist=loss_hist,
        )

    out = jax.lax.while_loop(cond, body, state)
    if return_state:
        return out["p"], out["loss_hist"], out["i"], out
    return out["p"], out["loss_hist"], out["i"]


class DeviceLinearLBFGS:
    """Host-steppable wrapper holding device-side history state.

    One `.step()` = THREE jitted dispatches (history update + two-loop
    direction; the direction render; on-device Armijo search + clamped
    update — see rebind() for why the render must live in its own
    program) — for drivers that need per-iteration control (timing
    artifacts, checkpointing, progressive schedules) but should not pay
    ~25 host round-trips per iteration like opt/lbfgs.LinearLBFGS.
    """

    def __init__(self, dir_fn, cand_fn, m=5, search_it=20, c1=1e-4,
                 clamp=True, history_dtype=jnp.float32):
        """dir_fn(z, *step_args) -> dvol; cand_fn(vol, dvol, alpha, z,
        *step_args) -> loss. Pass per-step device data (seed, engine
        params, target) through step(..., step_args=...) rather than
        closures — closure-captured device arrays are baked into the
        compiled executable as constants.

        history_dtype: storage dtype of the S/Yh circular buffers
        (2*m*n entries); bfloat16 halves their footprint. The curvature scalars (ys, gamma) are
        always computed from the f32 step/grad differences BEFORE
        quantization, and the two-loop dot products accumulate in f32,
        so only the stored direction vectors lose precision — a
        perturbation of the quasi-Newton direction that the Armijo
        safeguard absorbs."""
        self.m = m
        self.search_it = search_it
        self.c1 = c1
        self.clamp = clamp
        self.history_dtype = history_dtype
        self._state = None
        self.rebind(dir_fn, cand_fn)

    def rebind(self, dir_fn, cand_fn):
        """Swap the render/loss closures (e.g. a progressive-schedule
        integrator change) keeping the accumulated history state."""
        self._dir_fn = dir_fn
        self._cand_fn = cand_fn
        # THREE dispatches per step, not one: fused with the history
        # update, the direction RENDER's working set is planned
        # alongside the (m, n) history buffers and per-n temporaries,
        # which raises the program's peak memory. The state pytree is
        # donated: its buffers are dead the moment the step returns the
        # new state, so the circular history slot updates in place.
        self._pre_j = jax.jit(self._pre_impl, donate_argnums=(0,))
        self._dir_j = jax.jit(lambda z, step_args:
                              self._dir_fn(z, *step_args))
        self._post_j = jax.jit(self._post_impl)

    def init_state(self, p0):
        n = p0.shape[0]
        m = self.m
        return dict(
            t=jnp.int32(0),
            p_old=jnp.zeros((n,), jnp.float32),
            g_old=jnp.zeros((n,), jnp.float32),
            S=jnp.zeros((m, n), self.history_dtype),
            Yh=jnp.zeros((m, n), self.history_dtype),
            ys=jnp.ones((m,), jnp.float32),
            head=jnp.int32(0), nvalid=jnp.int32(0),
        )

    def _pre_impl(self, st, p, g):
        """History insert + two-loop direction (per-n arrays only)."""
        m = self.m
        sv = p - st["p_old"]
        yv = g - st["g_old"]
        ysv = _dot(yv, sv)
        norm = jnp.linalg.norm(yv) * jnp.linalg.norm(sv)
        accept = (st["t"] > 0) & jnp.isfinite(ysv) & \
            (ysv > 1e-10 * jnp.maximum(norm, 1e-30))
        head, nvalid = st["head"], st["nvalid"]
        S = _insert_row(st["S"], sv.astype(st["S"].dtype), head, accept)
        Yh = _insert_row(st["Yh"], yv.astype(st["Yh"].dtype), head,
                         accept)
        ys = st["ys"].at[head].set(jnp.where(accept, ysv,
                                             st["ys"][head]))
        head = jnp.where(accept, (head + 1) % m, head)
        nvalid = jnp.where(accept, jnp.minimum(nvalid + 1, m), nvalid)

        z = lbfgs_direction(g, S, Yh, ys, head, nvalid, m)
        g_dot_z = _dot(g, z)
        new_state = dict(t=st["t"] + 1, p_old=p, g_old=g, S=S, Yh=Yh,
                         ys=ys, head=head, nvalid=nvalid)
        return z, g_dot_z, new_state

    def _post_impl(self, p, z, vol, dvol, loss, g_dot_z, step_args):
        """On-device Armijo search + clamped parameter update."""
        def cand(vol, dvol, alpha, zz):
            return self._cand_fn(vol, dvol, alpha, zz, *step_args)

        alpha = armijo_search(cand, vol, dvol, z, loss,
                              g_dot_z, self.search_it, self.c1)
        p_new = p + alpha * z
        if self.clamp:
            p_new = jnp.maximum(p_new, 0.0)
        return p_new, alpha

    def step(self, p, g, vol, loss, step_args=()):
        """Returns updated (clamped) patterns; all-device, three
        dispatches (see rebind)."""
        if self._state is None or \
                self._state["p_old"].shape != p.shape:
            self._state = self.init_state(p)
        z, g_dot_z, self._state = self._pre_j(self._state, p, g)
        dvol = self._dir_j(z, step_args)
        p_new, alpha = self._post_j(p, z, vol, dvol, loss, g_dot_z,
                                    step_args)
        self.last_alpha = alpha
        return p_new

    # -- checkpointing ---------------------------------------------------

    def state_dict(self):
        import numpy as np
        if self._state is None:
            return {"t": np.int64(0)}
        d = {k: np.asarray(v) for k, v in self._state.items()}
        d["m"] = np.int64(self.m)
        return d

    def load_state_dict(self, d):
        if int(d.get("t", 0)) == 0:
            self._state = None
            return
        self._state = {k: jnp.asarray(d[k]) for k in
                       ("t", "p_old", "g_old", "S", "Yh", "ys", "head",
                        "nvalid")}

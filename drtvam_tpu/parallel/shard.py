"""Multi-chip scale-out: ray-space sharding over a device mesh.

The reference has NO distributed execution (single Dr.Jit wavefront on
one GPU, SURVEY.md §2.4); this layer is new design:

  * the (active-pixel x spp) ray wavefront is block-sharded over a 1-D
    `Mesh` axis 'rays' — angles/pixels land on chips in contiguous
    blocks, so each chip's pattern-gradient segment is nearly disjoint;
  * each chip ray-marches its lanes into a CHIP-LOCAL replica of the
    dose accumulator, then one `psum` over the interconnect reduces
    dose grids (forward) / pattern gradients (backward);
  * the host-side API mirrors ops.render: `make_sharded_render(mesh)`
    returns a drop-in `render_raw`-shaped callable with the same
    custom_vjp contract, so the optimizer stack is oblivious to the
    mesh. Multi-host: initialize jax.distributed outside and pass the
    global mesh.

Determinism: the lane->RNG mapping is global (counter-based on the
global lane id), so an N-chip render computes the SAME Monte-Carlo
estimate as the single-chip render up to float reduction order —
testable to tight tolerance (see tests/test_sharding.py).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.march import trace_wavefront
from ..ops.render import _chunking, _zero_ct, default_chunk
from ..models.projector import ray_weight

AXIS = "rays"


def make_mesh(devices=None):
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _local_lanes(n_lanes, n_dev):
    return -(-n_lanes // n_dev)


def make_sharded_render(mesh: Mesh):
    """Build a `render_raw(static, arr, active_data, seed, spp,
    spp_grad, chunk)` with forward dose and backward pattern-gradient
    psum-reduced over the mesh. Inputs are replicated; the result is
    replicated (XLA keeps per-chip copies in sync)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    def _forward(static, arr, active_data, seed, spp, chunk):
        n_lanes = static.projector.n_active * spp
        per_dev = _local_lanes(n_lanes, n_dev)
        chunk_l, n_chunks = _chunking(per_dev, chunk)
        arr2 = dict(arr)
        arr2["active_data"] = active_data

        def local(arr2, seed):
            didx = jax.lax.axis_index(AXIS)
            base = didx.astype(jnp.uint32) * jnp.uint32(per_dev)
            lane_base = jnp.arange(chunk_l, dtype=jnp.uint32) + base
            acc0 = jnp.zeros((static.sensor.n_cells,), jnp.float32)

            def body(i, acc):
                lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk_l)
                acc, _, _, _ = trace_wavefront(static, arr2, lane, seed, spp,
                                            acc=acc, n_valid=n_lanes)
                return acc

            acc = body(0, acc0) if n_chunks == 1 else \
                jax.lax.fori_loop(0, n_chunks, body, acc0)
            return jax.lax.psum(acc, AXIS)

        return jax.shard_map(local, mesh=mesh, in_specs=(P(), P()),
                             out_specs=P(), check_vma=False)(arr2, seed)

    def _adjoint(static, arr, seed, spp, chunk, dL_flat):
        n_active = static.projector.n_active
        n_lanes = n_active * spp
        per_dev = _local_lanes(n_lanes, n_dev)
        chunk_l, n_chunks = _chunking(per_dev, chunk)
        arr2 = dict(arr)
        arr2["active_data"] = jnp.zeros((n_active,), jnp.float32)

        def local(arr2, seed, dL):
            didx = jax.lax.axis_index(AXIS)
            base = didx.astype(jnp.uint32) * jnp.uint32(per_dev)
            lane_base = jnp.arange(chunk_l, dtype=jnp.uint32) + base
            pg0 = jnp.zeros((n_active,), jnp.float32)

            def body(i, pg):
                lane = lane_base + jnp.uint32(i) * jnp.uint32(chunk_l)
                _, g, _, _ = trace_wavefront(static, arr2, lane, seed, spp,
                                          dL_flat=dL, n_valid=n_lanes)
                aidx = jnp.minimum(lane // jnp.uint32(spp),
                                   jnp.uint32(n_active - 1)).astype(
                                       jnp.int32)
                return pg.at[aidx].add(g)

            pg = body(0, pg0) if n_chunks == 1 else \
                jax.lax.fori_loop(0, n_chunks, body, pg0)
            return jax.lax.psum(pg, AXIS)

        pg = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                           out_specs=P(), check_vma=False)(arr2, seed, dL_flat)
        w = ray_weight(static.projector, arr, spp, arr["print_time"])
        return pg * w

    @partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5, 6))
    def render_raw_sharded(static, arr, active_data, seed, spp, spp_grad,
                           chunk):
        return _forward(static, arr, active_data, seed, spp, chunk)

    def _fwd(static, arr, active_data, seed, spp, spp_grad, chunk):
        return _forward(static, arr, active_data, seed, spp, chunk), \
            (arr, seed)

    def _bwd(static, spp, spp_grad, chunk, res, ct):
        arr, seed = res
        pg = _adjoint(static, arr, seed, spp_grad, chunk, ct)
        arr_ct = {k: _zero_ct(v) for k, v in arr.items()}
        seed_ct = np.zeros(jnp.shape(seed), jax.dtypes.float0)
        return (arr_ct, pg, seed_ct)

    render_raw_sharded.defvjp(_fwd, _bwd)
    return render_raw_sharded


def render_sharded(mesh, static, arr, active_data, inv_vol, seed=0, spp=1,
                   spp_grad=None, chunk=None):
    """Sharded equivalent of ops.render.render."""
    if spp_grad is None:
        spp_grad = spp
    if chunk is None:
        chunk = default_chunk()
    seed = jnp.asarray(seed, jnp.uint32)
    raw = make_sharded_render(mesh)(static, arr, active_data, seed, spp,
                                    spp_grad, chunk)
    return raw.reshape(static.sensor.shape) * inv_vol


# --------------------------------------------------------------------------
# ballistic engine sharding: angles -> chips


def _sharded_adjoint(mesh, impl, U):
    """Angle-sharded adjoint: each device's pattern gradient depends only
    on the (replicated) dose cotangent, so it needs no collective and
    the result stays angle-sharded."""
    from ..ops.backproject import adjoint

    def run(dL, geo):
        return jax.shard_map(lambda g, d: adjoint(impl, d, g, U),
                             mesh=mesh, in_specs=(P(AXIS), P()),
                             out_specs=P(AXIS), check_vma=False)(geo, dL)

    return run


def make_sharded_backproject(mesh: Mesh, impl: str):
    """Angle-sharded ballistic backprojection. The per-angle operands
    (`ops.backproject.prepare`) and the pattern stack are block-sharded
    over the mesh axis; each device backprojects its own angle block
    into a local dose grid and ONE psum reduces the doses."""
    from ..ops.backproject import forward, zero_cotangent

    @jax.custom_vjp
    def bp(Pz, geo):
        def local(Pz, geo):
            return jax.lax.psum(forward(impl, Pz, geo), AXIS)

        return jax.shard_map(local, mesh=mesh,
                             in_specs=(P(AXIS), P(AXIS)),
                             out_specs=P(), check_vma=False)(Pz, geo)

    def _fwd(Pz, geo):
        return bp(Pz, geo), (geo, Pz.shape[2])

    def _bwd(res, dL):
        geo, U = res
        return (_sharded_adjoint(mesh, impl, U)(dL, geo),
                zero_cotangent(geo))

    bp.defvjp(_fwd, _bwd)
    return bp


def shard_ballistic_engine(eng, mesh: Mesh):
    """Re-point a BallisticEngine's backprojection at an angle-sharded
    mesh implementation and place its per-angle operands on the mesh.
    Angle count must divide evenly over the mesh (pad patterns upstream
    if needed). Returns the same engine, mutated."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    A = eng.shape_dense[0]
    assert A % n_dev == 0, \
        f"{A} angles do not divide over {n_dev} devices"
    from jax.sharding import NamedSharding
    eng.geo = jax.device_put(eng.geo, NamedSharding(mesh, P(AXIS)))
    eng._sharded_bp = make_sharded_backproject(mesh, eng.impl)
    eng._sharded_bwd = _sharded_adjoint(mesh, eng.impl, eng.shape_dense[2])
    return eng

"""Backprojection implementations: the Triton kernels (in interpret mode
here) == the plain XLA reference, the custom_vjp rule, the choice of
implementation, and the engine and angle-sharded paths on the kernels.

The compiled kernels run on the card only: `test_kernels_on_gpu`
(marker `gpu`) compares them there and skips on a host without one.
"""
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from drtvam_tpu.ops import backproject as bp


def _wide(rng, A, Y, X, U):
    """u scattered per cell: every tile spans the whole DMD."""
    return rng.uniform(-1.5, U + 0.5, (A, Y, X))


def _projected(rng, A, Y, X, U):
    """u an affine projection of (x, y) per angle, like the transport."""
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    scale = (U - 8) / np.hypot(Y, X)
    out = np.zeros((A, Y, X))
    for a in range(A):
        th = 2 * np.pi * a / A
        proj = np.cos(th) * xs + np.sin(th) * ys
        out[a] = (proj - proj.min()) * scale + 3.0 + \
            rng.uniform(-0.4, 0.4, (Y, X))
    return out


# (u-map kind, A, Y, X, U, Zf): tile multiples, then sizes that are not
# multiples of the cell tile, of the z block or of the adjoint's columns
CASES = {
    "wide": (_wide, 4, 16, 32, 100, 24),
    "projected": (_projected, 5, 32, 64, 140, 24),
    "ragged": (_projected, 3, 13, 21, 37, 70),
}


def _fields(kind, seed=0):
    umap, A, Y, X, U, Zf = CASES[kind]
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0  # holes: empty cells contribute nothing
    Umap = umap(rng, A, Y, X, U).astype(np.float32)
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return (jnp.asarray(Pz), jnp.asarray(W), jnp.asarray(Umap),
            jnp.asarray(dL), U)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the module in interpret mode."""
    orig = bp.pl.pallas_call
    monkeypatch.setattr(bp.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


@pytest.mark.parametrize("kind", list(CASES))
def test_fwd_triton_matches_xla(kind):
    Pz, W, Umap, dL, U = _fields(kind)
    geo = bp.prepare("triton", W, Umap, U)
    _close(bp._fwd_triton(Pz, geo, interpret=True),
           bp._fwd_xla(Pz, W, Umap))


@pytest.mark.parametrize("kind", list(CASES))
def test_bwd_triton_matches_xla(kind):
    Pz, W, Umap, dL, U = _fields(kind, seed=7)
    geo = bp.prepare("triton", W, Umap, U)
    _close(bp._bwd_triton(dL, geo, U, interpret=True),
           bp._bwd_xla(dL, W, Umap, U))


@pytest.mark.parametrize("impl", bp.IMPLS)
def test_vjp_rule_matches_reference_vjp(impl, interpret):
    """jax.vjp through the custom_vjp == jax.vjp of the plain forward."""
    Pz, W, Umap, dL, U = _fields("projected", seed=3)
    geo = bp.prepare(impl, W, Umap, U)
    out, vjp = jax.vjp(lambda p: bp.backproject(impl, p, geo), Pz)
    ref, vjp_ref = jax.vjp(lambda p: bp._fwd_xla(p, W, Umap), Pz)
    _close(out, ref)
    _close(vjp(dL)[0], vjp_ref(dL)[0])


def test_adjoint_table_holds_every_tap_once():
    Pz, W, Umap, dL, U = _fields("ragged")
    geo = bp.prepare("triton", W, Umap, U)
    i0, w0, w1 = bp._taps(bp._tile_major(W), bp._tile_major(Umap), U)
    n_used = int(jnp.sum(w0 != 0) + jnp.sum(w1 != 0))
    cw = np.asarray(geo.cw)
    assert np.count_nonzero(cw) == n_used
    np.testing.assert_allclose(cw.sum(axis=(1, 2)),
                               np.asarray(w0.sum(1) + w1.sum(1)),
                               rtol=1e-5)
    # per block of BU columns the kernel visits kmax entries: none lie
    # beyond it
    A, K, Up = cw.shape
    k = np.arange(K)[None, :, None]
    kmax = np.repeat(np.asarray(geo.kmax), bp.BU, axis=1)[:, None, :]
    assert not np.any(cw[np.broadcast_to(k >= kmax, cw.shape)])


def test_tile_major_roundtrip():
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(7, 13, 21)).astype(np.float32))
    back = bp._raster(bp._tile_major(x), 13, 21)
    np.testing.assert_array_equal(np.asarray(back),
                                  np.asarray(x).reshape(7, -1))


@pytest.mark.parametrize("platform,impl", [("cpu", "xla"),
                                           ("gpu", "triton"),
                                           ("metal", "xla")])
def test_default_impl_by_platform(monkeypatch, platform, impl):
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform=platform)])
    assert bp.default_impl() == impl


def test_unknown_impl_raises():
    Pz, W, Umap, dL, U = _fields("wide")
    for call in (lambda: bp.prepare("pallas", W, Umap, U),
                 lambda: bp.forward("pallas_band", Pz, {}),
                 lambda: bp.adjoint("mxu", dL, {}, U)):
        with pytest.raises(ValueError, match="unknown backprojection"):
            call()


def _engine_scene(tmp_path, n_patterns):
    from drtvam_tpu.models.scene import Scene
    from drtvam_tpu.ops.mesh import make_box, save_ply
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                 "ior": 1.54,
                 "medium": {"ior": 1.40, "extinction": 0.1,
                            "albedo": 0.0,
                            "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": n_patterns,
                      "resx": 24, "resy": 8, "pixel_size": 0.2,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": 20, "resy": 20,
                            "resz": 8}},
        "target": {"filename": path, "size": 4.0},
        "output": str(tmp_path),
    }
    scene = Scene(cfg)
    static, arr = scene.build(mode="volume", include_target=False)
    return scene, static, arr


def _render_and_grad(eng, scene, inv_vol):
    n = scene.projector.active_size()
    data = jnp.linspace(0.5, 1.5, n, dtype=jnp.float32)

    def f(d):
        v = eng.render_vol(d, inv_vol)
        return jnp.mean(jnp.square(v)), v

    (_, v), g = jax.jit(jax.value_and_grad(f, has_aux=True))(data)
    return v, g


def test_engine_triton_matches_xla(tmp_path, interpret):
    from drtvam_tpu.ops.ballistic import BallisticEngine
    scene, static, arr = _engine_scene(tmp_path, 6)
    inv_vol = jnp.float32(1.0 / scene.sensor.voxel_volume)
    v1, g1 = _render_and_grad(BallisticEngine(static, arr, impl="xla"),
                              scene, inv_vol)
    v2, g2 = _render_and_grad(
        BallisticEngine(static, arr, impl="triton"), scene, inv_vol)
    assert float(jnp.sum(v1)) > 0
    _close(v2, v1)
    _close(g2, g1)


def test_sharded_triton_engine_matches_single(tmp_path, interpret):
    from drtvam_tpu.ops.ballistic import BallisticEngine
    from drtvam_tpu.parallel.shard import make_mesh, shard_ballistic_engine
    scene, static, arr = _engine_scene(tmp_path, 8)
    inv_vol = jnp.float32(1.0 / scene.sensor.voxel_volume)
    mesh = make_mesh(jax.devices()[:4])
    v1, g1 = _render_and_grad(
        BallisticEngine(static, arr, impl="triton"), scene, inv_vol)
    eng4 = shard_ballistic_engine(
        BallisticEngine(static, arr, impl="triton"), mesh)
    v4, g4 = _render_and_grad(eng4, scene, inv_vol)
    _close(v4, v1)
    _close(g4, g1)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels have no "
                    "CPU lowering (interpret-mode tests cover the math)")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(CASES))
def test_kernels_on_gpu(gpu, kind):
    Pz, W, Umap, dL, U = _fields(kind)
    geo = bp.prepare("triton", W, Umap, U)
    _close(jax.jit(bp._fwd_triton)(Pz, geo), bp._fwd_xla(Pz, W, Umap))
    _close(jax.jit(lambda d, g: bp._bwd_triton(d, g, U))(dL, geo),
           bp._bwd_xla(dL, W, Umap, U))

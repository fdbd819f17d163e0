"""What the program needs from its runtime: the compile-cache location,
no call to JAX's CPU backend on the device path, and no optional
package (tqdm, matplotlib) on the main path."""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drtvam_tpu.utils import jax_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment(monkeypatch, restore_cache_dir,
                                    tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "cfg"))
    monkeypatch.setenv(jax_cache.ENV, str(tmp_path / "env"))
    assert jax_cache.enable_compile_cache() == str(tmp_path / "env")
    # the variable is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cfg")


def test_cache_dir_default_is_fixed(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(jax_cache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert jax_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert jax_cache.enable_compile_cache() == want


def test_chord_bank_needs_no_cpu_backend(monkeypatch, tmp_path):
    """With JAX_PLATFORMS=cuda there is no CPU backend: the hybrid
    engine's build must never ask for one."""
    from scene_fixtures import tiny_scattering_scene
    from drtvam_tpu.ops.hybrid import ScatteringEngine

    static, arr, data, inv_vol = tiny_scattering_scene(str(tmp_path))
    devices = jax.devices

    def no_cpu(backend=None):
        if backend == "cpu":
            raise RuntimeError("CPU backend requested")
        return devices(backend)

    monkeypatch.setattr(jax, "devices", no_cpu)
    eng = ScatteringEngine(static, arr, spp=1)
    bank = eng._arr["chord_pack"]
    A, U = static.projector.n_patterns, static.projector.resx
    assert bank.shape == (A * U, 12)
    assert np.all(np.isfinite(bank)) and np.any(bank[:, 8:10] > 0)


def test_optimize_without_tqdm_or_matplotlib(monkeypatch, tmp_path):
    from drtvam_tpu.ops.mesh import make_box, save_ply

    for mod in ("tqdm", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises
    for mod in ("drtvam_tpu.opt.optimize", "drtvam_tpu.utils.metrics"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    optimize = importlib.import_module("drtvam_tpu.opt.optimize").optimize

    save_ply(make_box((0.5, 0.5, 0.5)), str(tmp_path / "t.ply"))
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                 "ior": 1.54,
                 "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0,
                            "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 6, "resx": 16,
                      "resy": 8, "pixel_size": 0.3, "motion": "circular",
                      "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5,
                   "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 16, "resy": 16,
                            "resz": 8}},
        "target": {"filename": str(tmp_path / "t.ply"), "size": 4.0},
        "n_steps": 2,
        "output": str(tmp_path / "out"),
    }
    vol = optimize(cfg)
    out = tmp_path / "out"
    assert np.all(np.isfinite(vol))
    loss = np.load(out / "loss.npy")
    assert loss[1] < loss[0]
    assert (out / "metrics.json").exists()
    assert not (out / "histogram.png").exists()


def test_chip_smoke_refuses_a_host_without_gpu():
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "no GPU" in run.stderr

"""REAL multi-process execution of the sharded renderer: two OS
processes, jax.distributed with a localhost coordinator, gloo CPU
collectives — the same wiring a multi-host GPU cluster uses (one
process per host), minus the interconnect. Asserts the 2-process
global-mesh render and pattern gradient match the single-process result
(the global lane->RNG mapping makes the MC estimate
mesh-shape-invariant).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.scene_fixtures import tiny_scattering_scene


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    out = str(tmp_path)
    port = _free_port()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # 2 virtual devices per process -> 4-device global mesh across 2
    # processes (devices per process must be uniform for jax.distributed)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout)
    for pid, (p, stdout) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, \
            f"worker {pid} failed:\n{stdout[-4000:]}"
        assert "4 global devices" in stdout

    dose_mh = np.load(os.path.join(out, "dose_mh.npy"))
    grad_mh = np.load(os.path.join(out, "grad_mh.npy"))

    # single-process reference, same seed/spp (this pytest process)
    from drtvam_tpu.ops.render import render
    static, arr, data, inv_vol = tiny_scattering_scene(out)
    dose_1 = np.asarray(render(static, arr, data, inv_vol, seed=7,
                               spp=2))
    grad_1 = np.asarray(jax.grad(lambda p: jnp.sum(
        render(static, arr, p, inv_vol, seed=7, spp=2) ** 2))(data))

    assert dose_mh.sum() > 0
    np.testing.assert_allclose(dose_mh, dose_1, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(grad_mh, grad_1, rtol=5e-4, atol=1e-8)

"""True multi-process distributed-runtime test (SURVEY.md:274-276).

Spawns 2 OS processes that each own 4 virtual CPU devices, bring up the
jax.distributed coordinator (parallel/mesh.initialize_runtime — the
cross-process path that single-process suites never execute), build the
8-device global mesh, and run the deterministic cross-shard systematic
resampler. The 2-process result must be BITWISE-identical to the
single-process 8-device run of the same resampler — the BASELINE.json
determinism requirement across process layouts, not just shard counts.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_workers(tmp_path, mode, stem, timeout=300):
    """Launch 2 coordinator-connected worker processes (4 virtual CPU
    devices each) in the given mode; return the result npz."""
    port = _free_port()
    out = tmp_path / stem
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), "2", str(out),
             mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout)
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]
    return np.load(str(out) + ".npz" if not str(out).endswith(".npz")
                   else str(out))


def test_two_process_resample_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "mp_result.npz"
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), "2", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout)
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]
    got = np.load(str(out) + ".npz" if not str(out).endswith(".npz")
                  else str(out))

    # single-process oracle on the 8-device virtual mesh (same inputs)
    import jax
    import jax.numpy as jnp

    from modppl_tpu.parallel.distributed import shardmap_resample_fn
    from modppl_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(42)
    lw_np = rng.standard_normal(1024)
    lw_np = lw_np - np.logaddexp.reduce(lw_np)
    state_np = rng.standard_normal((1024, 2))

    mesh = make_mesh(sp=1)
    resample = shardmap_resample_fn(mesh)
    new_state, parents, log_total = resample(
        jax.random.PRNGKey(7), jnp.asarray(lw_np), jnp.asarray(state_np))

    np.testing.assert_array_equal(got["parents"], np.asarray(parents))
    np.testing.assert_array_equal(got["state"], np.asarray(new_state))
    np.testing.assert_array_equal(got["log_total"], np.asarray(log_total))


def test_two_process_pooled_hmc_matches_single_process(tmp_path):
    """VERDICT r3 #6: the pooled-adaptation bitwise-equality claim
    (adaptation.py:28-31) asserted ACROSS PROCESSES — the layout where
    cross-host collectives could silently diverge — not just across device counts."""
    port = _free_port()
    out = tmp_path / "mp_hmc.npz"
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), "2", str(out),
             "hmc"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout)
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]
    got = np.load(str(out) + ".npz" if not str(out).endswith(".npz")
                  else str(out))

    # single-process oracle: same pipeline on the in-process 8-device mesh
    import jax

    jax.config.update("jax_enable_x64", True)
    from modppl_tpu.parallel.mesh import make_mesh
    import tests._mp_worker as w

    us, aprobs, eps = w._hmc_case(make_mesh(sp=1))
    np.testing.assert_array_equal(got["us"], np.asarray(us))
    np.testing.assert_array_equal(got["aprobs"], np.asarray(aprobs))
    np.testing.assert_array_equal(got["eps"], np.asarray(eps))


def test_two_process_sharded_filter_matches_single_process(tmp_path):
    """VERDICT r4 #4: the HEADLINE sharded batched filter — the repo's
    most collective-dense code (halo ppermute + ring fallback, O(N) int32
    ancestor all_gather) — asserted bitwise across PROCESS layouts, both
    bootstrap and guided+rejuvenated configs, against the single-process
    8-device run of the identical pipeline."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import tests._mp_worker as w
    from modppl_tpu.parallel.mesh import make_mesh

    for mode, guided in (("filter", False), ("filter_guided", True)):
        got = _spawn_workers(tmp_path, mode, f"mp_{mode}.npz", timeout=420)
        state, lw, log_ml = w._filter_case(make_mesh(sp=1), guided)
        np.testing.assert_array_equal(got["state"], np.asarray(state))
        np.testing.assert_array_equal(got["log_weights"], np.asarray(lw))
        np.testing.assert_array_equal(got["log_ml"], np.asarray(log_ml))

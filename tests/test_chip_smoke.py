"""chip_smoke.py on the CPU: the script refuses to run without a GPU, and
every phase runs and passes its own checks at tiny sizes (the GPU check
lives in ``main``, not in the phases). Also the compilation-cache helper
the script and the bench share."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from modppl_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    res = _run_script(REPO, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_script(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


TINY = {
    "is_flagship": {},
    "smc_bootstrap": dict(num_particles=1 << 12, num_steps=4),
    "smc_guided": dict(num_particles=1 << 12, num_steps=4),
    "hmc_d3": dict(num_chains=64, num_warmup=100, num_samples=100),
    "hmc_logreg": dict(num_chains=64, num_warmup=100, num_samples=100,
                       dim=4, n_data=64),
    "hmc_d128": dict(num_chains=64, num_warmup=100, num_samples=100,
                     dim=4, cond=10.0),
    "nuts": dict(num_chains=64, num_warmup=100, num_samples=100),
    "chees": dict(num_chains=64, num_warmup=100, num_samples=100),
    "advi": dict(num_steps=300, num_mc=32, dim=4, n_data=64),
}


def test_every_phase_has_a_tiny_size():
    assert sorted(TINY) == sorted(
        f.__name__.removeprefix("phase_") for f in chip_smoke.PHASES)


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_size(name):
    rec = getattr(chip_smoke, f"phase_{name}")(**TINY[name])
    assert rec["phase"] == name
    assert rec["compile_s"] > 0 and rec["run_s"] > 0
    assert rec["checks"]
    for c in rec["checks"]:
        assert {"name", "value", "tol", "reason", "pass"} <= set(c)
        assert c["pass"], c
    assert rec["ok"]


def test_sharded_smc_phase_on_four_devices():
    rec = chip_smoke.phase_sharded_smc(jax.devices()[:4],
                                       num_particles=1 << 12, num_steps=4)
    assert rec["ok"], rec
    assert all(c["value"] == 0 for c in rec["checks"])


def test_pooled_hmc_phase_on_four_devices():
    # 40 chains: 10 per shard, not a power of two (the bench's 4 x 10^4
    # chains are not either)
    rec = chip_smoke.phase_pooled_hmc(jax.devices()[:4], num_chains=40,
                                      num_warmup=40, num_samples=20)
    assert rec["ok"], rec
    assert all(c["value"] == 0 for c in rec["checks"])


def test_moment_check_fails_on_a_wrong_oracle():
    draws = jax.random.normal(jax.random.PRNGKey(0), (16, 200, 2))
    ok = chip_smoke._moment_checks("x", draws, [0.0, 0.0], [1.0, 1.0])
    bad = chip_smoke._moment_checks("x", draws, [0.5, 0.0], [1.0, 2.0])
    assert all(c["pass"] for c in ok)
    assert not any(c["pass"] for c in bad)


@pytest.mark.parametrize("env", [{"JAX_COMPILATION_CACHE_DIR": "/elsewhere"},
                                 {}], ids=["set", "unset"])
def test_compilation_cache_dir(env):
    want = env.get("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    assert compile_cache.compilation_cache_dir(env) == want


@pytest.mark.parametrize("env", [{"JAX_COMPILATION_CACHE_DIR": "/elsewhere"},
                                 {}], ids=["set", "unset"])
def test_configure_compilation_cache(env, monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    path = compile_cache.configure_compilation_cache(env)
    if env:
        # JAX reads the variable itself; nothing else is set
        assert path == "/elsewhere" and calls == []
    else:
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

"""The GPU bring-up script off the GPU, and the compile-cache placement.

chip_smoke.py must refuse to run (non-zero exit, no result line) without an
NVIDIA GPU or without the package beside it; its checking machinery (NN
equivalence against the fp64 brute force, plan checks, steer vs the oracle)
is exercised here at tiny sizes through the Pallas interpreter.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_phase_nn_machinery_interpreted():
    """The equivalence phase, tiny shapes, both kernel forms, anchored to
    the fp64 brute force."""
    recs = cs.phase_nn(
        cases=[("const", 6, 300, 40, 2, False, cs._BOAT_SCALE),
               ("per_node", 12, 200, 24, 5, True, cs._QUAD_SCALE)],
        interpret=True)
    for rec in recs.values():
        assert rec["id_match"] == 1.0
        assert rec["worst_rel_excess"] <= cs.NN_TOL
        assert rec["ref_vs_fp64_excess"] <= 1e-9


def test_phase_steer_matches_oracle():
    rec = cs.phase_steer(n_cand=16)
    assert rec["max_state_error"] <= cs.STEER_TOL


def test_check_plan_rejects_collisions_and_misses():
    from lqrrt_jax.models import boat

    prob = boat.default_problem()

    class _P:
        plan_reached_goal = True
        x_seq = np.linspace(prob["x0"], prob["goal"], 50)

    with pytest.raises(cs.PhaseError, match="clearance"):
        cs.check_plan("straight line", prob, _P, margin=1.0)  # hits buoys
    _P.x_seq = np.stack([prob["x0"], prob["x0"]])
    with pytest.raises(cs.PhaseError, match="goal box"):
        cs.check_plan("stuck", prob, _P, margin=1.0)


@pytest.fixture
def _restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_cache_uses_env_dir_when_set(monkeypatch, tmp_path,
                                     _restore_cache_config):
    from lqrrt_jax.utils.cache import enable_persistent_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_cache_defaults_to_repo_dir(monkeypatch, _restore_cache_config):
    from lqrrt_jax.utils.cache import REPO_CACHE_DIR, enable_persistent_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert REPO_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert enable_persistent_cache() == REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR

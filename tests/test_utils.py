"""Aux subsystems: metrics sinks, phase timers, checkpoint/resume, watchdog,
and the atomic plan swap (SURVEY.md section 5)."""
import threading
import time

import numpy as np
import pytest

import lqrrt_jax
from lqrrt_jax.models import double_integrator as di
from lqrrt_jax.utils import (BufferSink, JsonlSink, PhaseTimer,
                             ReplanWatchdog, attach, load, save)


def _small_planner(**kw):
    prob = di.default_problem()
    defaults = dict(min_time=0.0, max_time=5.0, printing=False,
                    batch_size=32, capacity=256, nn_block=128, seed=1)
    defaults.update(kw)
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        **defaults)
    return prob, planner


def test_metrics_sinks(tmp_path):
    prob, planner = _small_planner()
    buf = BufferSink()
    jsonl = JsonlSink(str(tmp_path / "replans.jsonl"))
    attach(planner, buf, jsonl)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=1.0, pruning=False)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=1.0, pruning=False)
    assert len(buf.records) == 2
    assert buf.records[0]["replan_seq"] == 0
    assert buf.records[1]["replan_seq"] == 1
    for r in buf.records:
        assert {"nodes", "rounds", "expansions_per_s", "goal_found",
                "total_s", "ts"} <= set(r)
    s = buf.summary()
    assert s["replans"] == 2 and 0.0 <= s["goal_rate"] <= 1.0
    import json
    lines = (tmp_path / "replans.jsonl").read_text().strip().split("\n")
    assert len(lines) == 2 and json.loads(lines[0])["replan_seq"] == 0


def test_phase_timer_fences():
    import jax.numpy as jnp
    t = PhaseTimer()
    x = jnp.ones((256, 256))
    with t.phase("matmul", fence=x):
        y = x @ x
    with t.phase("matmul", fence=y):
        y = y @ y
    s = t.summary()
    assert s["matmul"]["count"] == 2 and s["matmul"]["total_s"] > 0


def test_checkpoint_roundtrip(tmp_path):
    prob, planner = _small_planner()
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=1.0, pruning=False)
    path = str(tmp_path / "ckpt.npz")
    save(planner, path, include_tree=True)

    _, fresh = _small_planner(seed=99)
    load(fresh, path)
    np.testing.assert_array_equal(fresh.x_seq, planner.x_seq)
    np.testing.assert_array_equal(fresh.u_seq, planner.u_seq)
    assert fresh.T == planner.T
    assert fresh.plan_reached_goal == planner.plan_reached_goal
    np.testing.assert_array_equal(np.asarray(fresh.goal),
                                  np.asarray(planner.goal))
    # tree restored: controller can query + visualize without replanning
    assert int(fresh._device_tree.size) == int(planner._device_tree.size)
    # resumed PRNG continues the stream: next keys match
    np.testing.assert_array_equal(np.asarray(fresh._key),
                                  np.asarray(planner._key))


def test_checkpoint_dim_mismatch(tmp_path):
    prob, planner = _small_planner()
    planner.update_plan(prob["x0"], prob["sample_space"],
                        specific_time=0.5, pruning=False)
    path = str(tmp_path / "ckpt.npz")
    save(planner, path)
    from lqrrt_jax.models import boat
    bprob = boat.default_problem()
    other = lqrrt_jax.Planner(
        bprob["dynamics"], bprob["lqr"], bprob["constraints"],
        horizon=1.0, dt=0.05, goal0=bprob["goal"], printing=False,
        batch_size=16, capacity=128, nn_block=128)
    with pytest.raises(ValueError, match="dims"):
        load(other, path)


def test_watchdog_fires_and_salvages():
    prob, planner = _small_planner(max_time=60.0)
    wd = ReplanWatchdog(planner, grace=0.0)
    with wd.guard(budget_s=1.0):
        reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                      goal_bias=0.1, pruning=False)
    assert wd.fired and wd.fire_count == 1
    assert planner.x_seq is not None          # best-so-far salvage
    del reached


def test_watchdog_disarms_cleanly():
    prob, planner = _small_planner()
    wd = ReplanWatchdog(planner, grace=10.0)
    with wd.guard(budget_s=10.0):
        planner.update_plan(prob["x0"], prob["sample_space"],
                            specific_time=0.3, pruning=False)
    time.sleep(0.05)
    assert not wd.fired


def test_atomic_plan_swap_under_concurrent_reads():
    """get_state/get_effort from a controller thread must never see a torn
    plan while replans commit (SURVEY.md section 5.2)."""
    prob, planner = _small_planner()
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=0.5, pruning=False)
    n = planner.nstates
    errors = []
    stop = threading.Event()

    def controller():
        while not stop.is_set():
            try:
                x = planner.get_state(1.0)
                u = planner.get_effort(1.0)
                if x.shape != (n,) or u.shape != (planner.ncontrols,):
                    errors.append("shape")
                # consistency: T must match the x_seq the state came from
                plan = planner._plan
                if abs(plan[2] - planner.dt * (len(plan[0]) - 1)) > 1e-6:
                    errors.append("torn")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    th = threading.Thread(target=controller)
    th.start()
    try:
        for _ in range(3):
            planner.update_plan(prob["x0"], prob["sample_space"],
                                goal_bias=0.2, specific_time=0.3,
                                pruning=False)
    finally:
        stop.set()
        th.join()
    assert not errors, errors[:5]


def test_checkpoint_loads_pre_n_children_trees(tmp_path):
    """Format-2 checkpoints written before child counting existed load with
    n_children reconstructed exactly from the parent array."""
    import jax.numpy as jnp
    from lqrrt_jax.utils import checkpoint

    prob = di.default_problem()
    p = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=256, nn_block=128,
        saturate=prob["saturate"], seed=4)
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  pruning=False, specific_time=0.2)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(p, path, include_tree=True)

    # strip the n_children field to emulate an old checkpoint
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k != "tree_n_children"}
    np.savez_compressed(path, **data)

    q = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=256, nn_block=128,
        saturate=prob["saturate"], seed=4)
    checkpoint.load(q, path)
    told, tnew = p._device_tree, q._device_tree
    sz = int(told.size)
    np.testing.assert_array_equal(np.asarray(told.n_children)[:sz],
                                  np.asarray(tnew.n_children)[:sz])
    np.testing.assert_allclose(np.asarray(told.state)[:sz],
                               np.asarray(tnew.state)[:sz])


def test_animate_planner_writes_gif(tmp_path):
    """C12 animation parity: tree-growth replay + vehicle trace saved as GIF."""
    from lqrrt_jax.viz import animate_planner

    prob = di.default_problem()
    p = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=128, nn_block=128,
        saturate=prob["saturate"], seed=4)
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  pruning=False, specific_time=0.2)
    out = str(tmp_path / "anim.gif")
    animate_planner(p, path=out, growth_frames=4, fps=5, dpi=40)
    import os as _os
    assert _os.path.getsize(out) > 1000

"""Multi-device Planner facade tests (SURVEY.md section 7 step 7, 2.4 P1/P2):
the full update_plan surface — anytime budget, kill, FPR, pruning,
finish_on_goal, extraction — running chunked sharded rounds over the 8-device
virtual CPU mesh, with semantics equality against the single-chip planner.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import lqrrt_jax
from lqrrt_jax.core.sampling import sample_batch
from lqrrt_jax.models import double_integrator as di
from lqrrt_jax.parallel import mesh as meshlib


N_DEV = 8


@pytest.fixture(scope="module")
def prob():
    return di.default_problem()


def _mk_planner(prob, mesh=None, seed=3, batch=64, capacity=1024, **kw):
    return lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=batch, capacity=capacity, nn_block=256,
        saturate=prob["saturate"], seed=seed, mesh=mesh, **kw)


def _fixed_chunk_clock(n_chunks):
    """sys_time stub that lets exactly n_chunks chunk dispatches happen:
    call 1 = t0, calls 2..n_chunks+1 = loop-top budget checks -> 0.0,
    later calls -> past the budget."""
    state = {"n": 0}

    def clock():
        state["n"] += 1
        return 0.0 if state["n"] <= n_chunks + 1 else 1e9
    return clock


def test_mesh_planner_reaches_goal(prob):
    assert jax.device_count() == N_DEV
    mesh = meshlib.make_mesh(N_DEV)
    planner = _mk_planner(prob, mesh=mesh)
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, pruning=True,
                                  specific_time=20.0)
    assert reached
    # plan invariants: starts at x0, ends inside the goal buffer
    np.testing.assert_allclose(planner.x_seq[0], prob["x0"], atol=1e-5)
    err = np.abs(np.asarray(prob["goal"]) - planner.x_seq[-1])
    assert np.all(err <= np.asarray(prob["constraints"].goal_buffer) + 1e-5)
    assert planner.T > 0
    # the tree is replicated: host snapshot is consistent
    tree = planner.get_tree()
    assert tree.size > 1


def test_mesh_planner_matches_singlechip(prob):
    """Bit-equality of the grown tree and the committed plan: a single-chip
    planner fed an xrand_gen that reproduces the mesh's per-device key folds
    must produce the identical tree (same commit path, same NN, same steer) —
    the planner-facade version of test_sharded.py's round equality."""
    mesh = meshlib.make_mesh(N_DEV)
    batch = 64

    mesh_p = _mk_planner(prob, mesh=mesh, seed=11, batch=batch,
                         rounds_per_chunk=2)
    mesh_p.sys_time = _fixed_chunk_clock(2)

    gb = None  # captured below per update_plan args
    space = jnp.asarray(prob["sample_space"], jnp.float32).reshape(4, 2)
    goal = jnp.asarray(prob["goal"], jnp.float32)

    def emulate_mesh_sampler(k, B):
        xs = []
        for d in range(N_DEV):
            kd = jax.random.fold_in(k, d)
            xs.append(sample_batch(kd, B // N_DEV, space, gb, goal))
        return jnp.concatenate(xs, 0)

    single_p = _mk_planner(prob, mesh=None, seed=11, batch=batch,
                           rounds_per_chunk=2)
    single_p.sys_time = _fixed_chunk_clock(2)

    gb = jnp.full((4,), 0.15, jnp.float32)
    r_mesh = mesh_p.update_plan(prob["x0"], prob["sample_space"],
                                goal_bias=0.15, pruning=False,
                                specific_time=0.5)
    r_one = single_p.update_plan(prob["x0"], prob["sample_space"],
                                 goal_bias=0.15, pruning=False,
                                 xrand_gen=emulate_mesh_sampler,
                                 specific_time=0.5)
    assert r_mesh == r_one
    tm, t1 = mesh_p._device_tree, single_p._device_tree
    assert int(tm.size) == int(t1.size) > 1
    np.testing.assert_allclose(np.asarray(tm.state), np.asarray(t1.state),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tm.parent),
                                  np.asarray(t1.parent))
    np.testing.assert_allclose(mesh_p.x_seq, single_p.x_seq, atol=1e-5)


def test_mesh_planner_topk_collective(prob):
    """topk best-edge exchange: at most k commits per round, still reaches
    the goal with the full anytime surface on top."""
    mesh = meshlib.make_mesh(N_DEV)
    k = 16
    planner = _mk_planner(prob, mesh=mesh, collective="topk", topk=k,
                          batch=64, rounds_per_chunk=4)
    planner.sys_time = _fixed_chunk_clock(6)
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, pruning=True,
                                  finish_on_goal=True, specific_time=0.5)
    rounds = planner.stats["rounds"]
    assert planner.stats["nodes"] <= 1 + rounds * k
    assert reached
    err = np.abs(np.asarray(prob["goal"]) - planner.x_seq[-1])
    assert np.all(err <= np.asarray(prob["constraints"].goal_buffer) + 1e-5)


def test_mesh_planner_fpr_and_kill(prob):
    """FPR warm start and chunk-boundary preemption work identically on the
    mesh; FPR keeps the chunk cache at one compiled variant across replans."""
    mesh = meshlib.make_mesh(N_DEV)
    planner = _mk_planner(prob, mesh=mesh, FPR=0.25, batch=64,
                          rounds_per_chunk=2)
    def n_grow_chunks():
        return sum(1 for k in planner._chunk_cache
                   if k[3] in ("grow", "restart"))

    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        pruning=False, specific_time=1.0)
    assert n_grow_chunks() == 1
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        pruning=False, specific_time=1.0)
    assert n_grow_chunks() == 1  # FPR replan reuses the chunk

    # kill: flag up via the sys_time hook -> exits at the next chunk boundary
    calls = {"n": 0}
    import time as _time

    def killing_clock():
        calls["n"] += 1
        if calls["n"] == 3:
            planner.kill_update()
        return _time.time()

    planner.sys_time = killing_clock
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        pruning=False)
    assert planner.x_seq is not None  # best-so-far salvage


def test_mesh_batch_divisibility_error(prob):
    mesh = meshlib.make_mesh(N_DEV)
    with pytest.raises(ValueError, match="divide"):
        _mk_planner(prob, mesh=mesh, batch=60)


def test_mesh_planner_dynamic_obstacle_data(prob):
    """feasibility_data threading works under shard_map too: the obstacle
    pytree is replicated through the chunk, zero recompiles on updates."""
    from lqrrt_jax.constraints import Constraints
    from lqrrt_jax.ops.collision import circles_free_data

    base = di.default_problem(obstacles=False)
    data0 = {"centers": np.array([[1.5, 0.0]], np.float32),
             "radii": np.array([0.5], np.float32)}
    cons = Constraints(nstates=4, ncontrols=2,
                       goal_buffer=base["constraints"].goal_buffer,
                       is_feasible=circles_free_data(margin=0.05),
                       feasibility_data=data0)
    mesh = meshlib.make_mesh(N_DEV)
    planner = lqrrt_jax.Planner(
        base["dynamics"], base["lqr"], cons, horizon=base["horizon"],
        dt=base["dt"], goal0=base["goal"], printing=False, batch_size=64,
        capacity=512, nn_block=128, saturate=base["saturate"], seed=2,
        mesh=mesh)
    def n_grow():
        # refine chunks may lazily compile whenever the tree hits capacity;
        # only a new grow/restart variant would indicate a feasibility retrace
        return sum(1 for k in planner._chunk_cache
                   if k[3] in ("grow", "restart"))

    assert planner.update_plan(base["x0"], base["sample_space"],
                               goal_bias=0.2, specific_time=2.0)
    assert n_grow() == 1
    cons.set_feasibility_data({"centers": np.array([[1.2, 0.2]], np.float32),
                               "radii": np.array([0.6], np.float32)})
    assert planner.update_plan(base["x0"], base["sample_space"],
                               goal_bias=0.2, specific_time=2.0)
    assert n_grow() == 1
    d = np.linalg.norm(np.asarray(planner.x_seq)[:, :2]
                       - np.array([1.2, 0.2]), axis=1) - 0.6
    assert d.min() > 0.0


def test_mesh_planner_2d_hosts_chips(prob):
    """2-D (hosts x chips) mesh (P5): candidates shard over BOTH axes via
    the axis-name tuple; result is bit-identical to the 1-D 8-device mesh
    (the flat axis_index makes the per-device key folds line up)."""
    mesh2d = meshlib.make_mesh_2d(2, 4)
    p2 = _mk_planner(prob, mesh=mesh2d, seed=11, batch=64,
                     rounds_per_chunk=2, mesh_axis=("host", "dp"))
    p2.sys_time = _fixed_chunk_clock(2)
    p1 = _mk_planner(prob, mesh=meshlib.make_mesh(N_DEV), seed=11, batch=64,
                     rounds_per_chunk=2)
    p1.sys_time = _fixed_chunk_clock(2)
    r2 = p2.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.15,
                        pruning=False, specific_time=0.5)
    r1 = p1.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.15,
                        pruning=False, specific_time=0.5)
    assert r2 == r1
    t2, t1 = p2._device_tree, p1._device_tree
    assert int(t2.size) == int(t1.size) > 1
    np.testing.assert_allclose(np.asarray(t2.state), np.asarray(t1.state),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(t2.parent),
                                  np.asarray(t1.parent))

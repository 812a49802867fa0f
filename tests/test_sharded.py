"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md section 4
item 4): sharded expansion rounds (P1/P2) and fleet scenario parallelism (P4).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lqrrt_jax.core.rounds import RoundSpec, make_round
from lqrrt_jax.core.tree import init_tree, best_node
from lqrrt_jax.models import double_integrator as di
from lqrrt_jax.parallel import mesh as meshlib
from lqrrt_jax.parallel.fleet import FleetPlanner
from lqrrt_jax.parallel.sharded import (jit_sharded_round, make_sharded_round,
                                        replicate_tree)


@pytest.fixture(scope="module")
def prob():
    return di.default_problem()


def _spec(batch=64, cap=512):
    return RoundSpec(nstates=4, ncontrols=2, batch=batch, horizon_steps=20,
                     capacity=cap, dt=0.05, nn_block=128)


def _seed_tree(prob, spec):
    S0, K0 = prob["lqr"](None, None)
    return init_tree(spec.capacity, spec.horizon_steps, 4, 2,
                     jnp.asarray(prob["x0"]), S0, K0, 1e9, False)


def test_sharded_round_grows_and_replicates(prob):
    assert jax.device_count() == 8
    m = meshlib.make_mesh(8)
    spec = _spec()
    rf = make_sharded_round(spec, m, prob["dynamics"], prob["lqr"],
                            prob["erf"], prob["constraints"].is_feasible,
                            0.05, prob["constraints"].goal_buffer,
                            saturate=prob["saturate"])
    rfj = jit_sharded_round(rf, m)
    tree = replicate_tree(_seed_tree(prob, spec), m)
    key = jax.random.PRNGKey(0)
    gb = jnp.full((4,), 0.1)
    goal = jnp.asarray(prob["goal"])
    space = jnp.asarray(prob["sample_space"])
    for i in range(3):
        tree = rfj(tree, jax.random.fold_in(key, i), goal, space, gb, goal)
    size = int(tree.size)
    assert size > 1, "sharded round committed nothing"
    # replication invariant: every leaf fully addressable, values consistent
    st = np.asarray(tree.state)
    assert st.shape == (spec.capacity, 4)
    # parents of committed nodes are valid and precede them
    parent = np.asarray(tree.parent)[:size]
    assert parent[0] == -1
    assert np.all(parent[1:] >= 0) and np.all(parent[1:] < size)


def test_sharded_round_matches_singlechip_commit_semantics(prob):
    """Same candidate set -> same tree, sharded or not: run the single-chip
    round on the all-gathered sample batch the sharded round would draw."""
    m = meshlib.make_mesh(8)
    spec = _spec(batch=64)
    common = dict(error_tol=0.05,
                  goal_buffer=prob["constraints"].goal_buffer,
                  saturate=prob["saturate"])
    rf_sh = make_sharded_round(spec, m, prob["dynamics"], prob["lqr"],
                               prob["erf"], prob["constraints"].is_feasible,
                               common["error_tol"], common["goal_buffer"],
                               saturate=common["saturate"])
    tree0 = _seed_tree(prob, spec)
    key = jax.random.PRNGKey(42)
    gb = jnp.zeros(4)
    goal = jnp.asarray(prob["goal"]); space = jnp.asarray(prob["sample_space"])
    tree_sh = jax.jit(rf_sh)(replicate_tree(tree0, m), key, goal, space, gb,
                             goal)

    # reproduce the exact per-device sample batch on one chip
    from lqrrt_jax.core.sampling import sample_batch
    xs = []
    for d in range(8):
        kd = jax.random.fold_in(key, d)
        xs.append(sample_batch(kd, spec.batch // 8, space, gb, goal))
    xrand = jnp.concatenate(xs, 0)
    rf_1 = make_round(spec, prob["dynamics"], prob["lqr"], prob["erf"],
                      prob["constraints"].is_feasible, common["error_tol"],
                      common["goal_buffer"], saturate=common["saturate"],
                      xrand_gen=lambda k, B: xrand)
    tree_1 = jax.jit(rf_1)(tree0, key, goal, space, gb, goal)

    assert int(tree_sh.size) == int(tree_1.size)
    np.testing.assert_allclose(np.asarray(tree_sh.state),
                               np.asarray(tree_1.state), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tree_sh.parent),
                                  np.asarray(tree_1.parent))


def test_topk_collective_matches_singlechip_topk(prob):
    """The psum-assembled topk winners must BIT-match a single-chip round
    that commits the identical global top-k selection (bounding node counts
    alone would not catch a wrong selection).  The candidate batch
    includes engineered score TIES (duplicate samples — owner masking and
    tie-breaking are exactly where the collective would break silently) and
    one ALL-INFEASIBLE shard (device 3 samples its own root state: zero
    error => arrived at step 0 => length 0 => score inf)."""
    from lqrrt_jax.core.rounds import commit_candidates, make_expand
    from lqrrt_jax.core.sampling import sample_batch
    from lqrrt_jax.parallel.sharded import candidate_scores

    m = meshlib.make_mesh(8)
    spec = _spec(batch=64)
    K = 8
    gb = jnp.zeros(4)
    goal = jnp.asarray(prob["goal"])
    space = jnp.asarray(prob["sample_space"])
    x0 = jnp.asarray(prob["x0"])

    def shard_gen(k, B):
        # duplicate each device's first two samples (ties) and make device
        # 3's whole shard the root state (all-infeasible shard)
        idx = jax.lax.axis_index("dp")
        xs = sample_batch(k, B, space, gb, goal)
        xs = xs.at[1].set(xs[0])
        return jnp.where(idx == 3, jnp.broadcast_to(x0, (B, 4)), xs)

    rf_sh = make_sharded_round(spec, m, prob["dynamics"], prob["lqr"],
                               prob["erf"], prob["constraints"].is_feasible,
                               0.05, prob["constraints"].goal_buffer,
                               saturate=prob["saturate"], xrand_gen=shard_gen,
                               collective="topk", topk=K)
    tree0 = _seed_tree(prob, spec)
    key = jax.random.PRNGKey(9)
    tree_sh = jax.jit(rf_sh)(replicate_tree(tree0, m), key, goal, space, gb,
                             goal)

    # single-chip reference: same candidates, same global top-k, same commit
    xs = []
    for d in range(8):
        kd = jax.random.fold_in(key, d)
        x = sample_batch(kd, spec.batch // 8, space, gb, goal)
        x = x.at[1].set(x[0])
        if d == 3:
            x = jnp.broadcast_to(x0, (spec.batch // 8, 4))
        xs.append(x)
    xrand = jnp.concatenate(xs, 0)
    expand = make_expand(spec, prob["dynamics"], prob["lqr"], prob["erf"],
                         prob["constraints"].is_feasible, 0.05,
                         prob["constraints"].goal_buffer,
                         saturate=prob["saturate"])

    @jax.jit
    def one_chip(tree, xrand):
        c = expand(tree, xrand, goal)
        score = candidate_scores(tree, c, spec.dt)
        _, gidx = jax.lax.top_k(-score, K)
        # candidate axis is LAST for the time-major rollout buffers
        winners = c._replace(
            **{f: (getattr(c, f)[..., gidx] if f in ("x_seq", "u_seq")
                   else getattr(c, f)[gidx]) for f in c._fields})
        winners = winners._replace(
            length=jnp.where(jnp.take(score, gidx) < jnp.inf,
                             winners.length, 0))
        return commit_candidates(spec, tree, winners)

    tree_1 = one_chip(tree0, xrand)
    assert int(tree_sh.size) == int(tree_1.size) > 1
    # structure exactly equal; float fields to fp tolerance (XLA compiles
    # different batch shapes with different vectorization tails, so last-ulp
    # differences are expected — same precedent as the gather test above)
    for f in ("parent", "edge_len", "in_goal", "n_children"):
        np.testing.assert_array_equal(
            np.asarray(getattr(tree_sh, f)), np.asarray(getattr(tree_1, f)),
            err_msg=f)
    for f in ("state", "node_time", "goal_cost"):
        np.testing.assert_allclose(
            np.asarray(getattr(tree_sh, f)), np.asarray(getattr(tree_1, f)),
            atol=1e-5, err_msg=f)
    # the all-infeasible shard contributed nothing: no committed node state
    # equals the root duplicate beyond the root itself
    size = int(tree_sh.size)
    st = np.asarray(tree_sh.state)[1:size]
    assert not np.any(np.all(np.abs(st - np.asarray(x0)) < 1e-7, axis=1))


def test_refine_round_mesh_matches_singlechip(prob):
    """Mesh refine mode (leaf replacement + replicated rewire) bit-matches
    the single-chip refine round on a saturated tree (top_k tie-breaking inside commit_batch_refine must be identical or
    replicated trees silently diverge)."""
    from lqrrt_jax.core.rounds import make_refine_round
    from lqrrt_jax.core.sampling import sample_batch

    m = meshlib.make_mesh(8)
    spec = _spec(batch=64, cap=128)
    gb = jnp.full((4,), 0.1)
    goal = jnp.asarray(prob["goal"])
    space = jnp.asarray(prob["sample_space"])
    common = dict(saturate=prob["saturate"])

    # saturate a tree with plain grow rounds first
    grow = jax.jit(make_round(spec, prob["dynamics"], prob["lqr"],
                              prob["erf"], prob["constraints"].is_feasible,
                              0.05, prob["constraints"].goal_buffer,
                              **common))
    tree = _seed_tree(prob, spec)
    key = jax.random.PRNGKey(5)
    for i in range(4):
        tree = grow(tree, jax.random.fold_in(key, i), goal, space, gb, goal)
    assert int(tree.size) == spec.capacity

    rf_sh = make_sharded_round(spec, m, prob["dynamics"], prob["lqr"],
                               prob["erf"], prob["constraints"].is_feasible,
                               0.05, prob["constraints"].goal_buffer,
                               commit="refine", **common)
    k_ref = jax.random.fold_in(key, 100)
    tree_sh = jax.jit(rf_sh)(replicate_tree(tree, m), k_ref, goal, space,
                             gb, goal)

    # single-chip: emulate the mesh's per-device sample folds (half batch)
    local_half = max(spec.batch // 8 // 2, 1)

    def emulate(k, B):
        xs = [sample_batch(jax.random.fold_in(k, d), local_half, space, gb,
                           goal) for d in range(8)]
        return jnp.concatenate(xs, 0)

    rf_1 = make_refine_round(spec, prob["dynamics"], prob["lqr"],
                             prob["erf"], prob["constraints"].is_feasible,
                             0.05, prob["constraints"].goal_buffer,
                             xrand_gen=emulate, **common)
    tree_1 = jax.jit(rf_1)(tree, k_ref, goal, space, gb, goal)

    assert int(tree_sh.size) == int(tree_1.size) == spec.capacity
    for f in ("parent", "edge_len", "in_goal", "n_children"):
        np.testing.assert_array_equal(
            np.asarray(getattr(tree_sh, f)), np.asarray(getattr(tree_1, f)),
            err_msg=f)
    for f in ("state", "node_time", "goal_cost"):
        np.testing.assert_allclose(
            np.asarray(getattr(tree_sh, f)), np.asarray(getattr(tree_1, f)),
            atol=1e-5, err_msg=f)


def test_fleet_planner(prob):
    m = meshlib.make_fleet_mesh(8)
    S = 16
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=S, batch_size=32, capacity=256,
        nn_block=128, saturate=prob["saturate"], mesh=m, seed=1)
    rng = np.random.default_rng(0)
    x0s = np.zeros((S, 4), np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, S)
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    stats = fleet.plan(x0s, goals, prob["sample_space"],
                       goal_bias=0.2, rounds=8)
    assert stats["sizes"].shape == (S,)
    assert np.all(stats["sizes"] > 1), stats["sizes"]
    # per-scenario plan extraction works and starts at the right x0
    plan0 = fleet.extract_plan(0)
    np.testing.assert_allclose(plan0[0], x0s[0], atol=1e-5)
    # scenarios are actually different trees
    plan1 = fleet.extract_plan(1)
    assert plan0.shape != plan1.shape or not np.allclose(plan0, plan1)


def test_fleet_wallclock_budget_and_goal_times(prob):
    """max_time= runs chunked anytime dispatches: rounds stop at the budget,
    per-scenario time-to-first-goal is recorded, and explicit ncontrols=
    skips the lqr(x0, None) probe (which re-linearized lqr callbacks that
    use u cannot survive)."""
    probe_free_lqr = prob["lqr"]

    def lqr_uses_u(x, u):
        # re-linearized style: touches u, so probing with u=None must fail
        return probe_free_lqr(x, u + 0.0 * u)

    fleet = FleetPlanner(
        lambda x, u, dt: prob["dynamics"](x, u, dt), prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=4, batch_size=16, capacity=256,
        nn_block=128, saturate=prob["saturate"], mesh=None, ncontrols=2,
        seed=5)
    x0s = np.zeros((4, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (4, 1))
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                       rounds=64, max_time=3.0, rounds_per_chunk=2)
    assert stats["rounds"] <= 64
    assert stats["elapsed_s"] > 0
    found = stats["goal_found"]
    gt = stats["goal_time_s"]
    assert np.all(np.isfinite(gt[found]))        # found => time recorded
    assert np.all(np.isnan(gt[~found]))          # not found => nan
    assert np.all(gt[found] <= stats["elapsed_s"] + 1e-3)

    # the probe error path: lqr that uses u and no ncontrols= -> clear error
    bad = FleetPlanner(
        prob["dynamics"], lqr_uses_u, prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=2, batch_size=8, capacity=64,
        nn_block=64)
    with pytest.raises(ValueError, match="ncontrols"):
        bad.plan(x0s[:2], goals[:2], prob["sample_space"], goal_bias=0.2,
                 rounds=1)


def test_fleet_per_scenario_worlds_and_batched_extraction(prob):
    """Each scenario gets its OWN obstacle set (per-scenario feasibility
    data) and the batched extractor returns the
    same plans as per-scenario extraction, in one gather."""
    from lqrrt_jax.ops.collision import circles_free_data

    m = meshlib.make_fleet_mesh(8)
    S = 8
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        circles_free_data(margin=0.1), prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=S, batch_size=32, capacity=256,
        nn_block=128, saturate=prob["saturate"], mesh=m, seed=3,
        ncontrols=2, per_scenario_data=True)
    rng = np.random.default_rng(1)
    x0s = np.zeros((S, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    # scenario s has one circle at a scenario-specific spot; scenario 0's
    # circle blocks the straight line, scenario 7's is far away
    centers = np.stack([[3.0 + 0.2 * s, 0.0 + 0.5 * s] for s in range(S)]
                       ).astype(np.float32)[:, None, :]
    radii = np.full((S, 1), 0.8, np.float32)
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                       rounds=12,
                       feasibility_data={"centers": centers, "radii": radii})
    assert np.all(stats["sizes"] > 1)
    # every committed node respects ITS OWN scenario's circle
    sizes = stats["sizes"]
    st = np.asarray(fleet.trees.state)
    for s in range(S):
        d = np.linalg.norm(st[s, :sizes[s], :2] - centers[s, 0], axis=1)
        assert d.min() > 0.8, f"scenario {s} violated its own obstacle"
    # batched extraction == a manual host climb (old loop semantics)
    plans = fleet.extract_plans()
    assert set(plans) == set(range(S))
    from lqrrt_jax.core.tree import best_node
    for s in (0, 3, 7):
        np.testing.assert_allclose(plans[s][0], x0s[s], atol=1e-5)
        t = jax.tree.map(lambda a: a[s], fleet.trees)
        chain, i = [], int(best_node(t))
        parent = np.asarray(t.parent)
        while i != -1:
            chain.append(i)
            i = int(parent[i])
        chain = chain[::-1]
        xs = [np.asarray(t.state[chain[0]])[None]]
        for k in range(1, len(chain)):
            ln = int(np.asarray(t.edge_len[chain[k]]))
            xs.append(np.asarray(t.edge_x[:ln, :, chain[k]]))  # time-major
        ref = np.concatenate(xs, 0)
        np.testing.assert_allclose(plans[s], ref, atol=1e-6)


def test_fleet_budget_clamp(prob):
    """The budget binds on BOTH a cold and a warm plan(): cold, compile is
    paid before the internal t0 (plus a 1-round probe chunk), so elapsed_s
    respects max_time; warm, the end-to-end wall clock respects it too
    (a cold compile must not land inside the timed window)."""
    import time as _time
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=4, batch_size=32, capacity=4096,
        nn_block=128, saturate=prob["saturate"], mesh=None, ncontrols=2)
    x0s = np.zeros((4, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (4, 1))
    budget = 2.0
    # cold call: trace+compile happens, but OUTSIDE the timed budget — the
    # internal elapsed must still respect max_time
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2,
                       rounds=10_000, max_time=budget, rounds_per_chunk=16)
    assert stats["rounds"] < 10_000            # budget actually bound it
    assert stats["elapsed_s"] <= budget * 1.5 + 0.5, stats["elapsed_s"]
    # warm call: end-to-end wall clock now bounds the budget too.  Generous
    # CI slack; the runaway mode this guards against is a whole extra
    # 16-round chunk past the deadline.
    t0 = _time.time()
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2,
                       rounds=10_000, max_time=budget, rounds_per_chunk=16)
    wall = _time.time() - t0
    assert stats["rounds"] < 10_000
    assert wall <= budget * 1.5 + 0.5, wall


def test_fleet_unsharded_fallback(prob):
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=0.05, n_scenarios=4, batch_size=16, capacity=128,
        nn_block=128, saturate=prob["saturate"], mesh=None)
    x0s = np.zeros((4, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (4, 1))
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2,
                       rounds=4)
    assert np.all(stats["sizes"] > 1)

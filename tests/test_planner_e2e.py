"""End-to-end planner tests on the D1 double-integrator (milestone M1,
SURVEY.md section 7) plus property tests: every returned plan must be feasible
at every dt, end inside goal_buffer when goal_reached, and respect limits
(SURVEY.md section 4 item 3)."""
import numpy as np
import jax.numpy as jnp
import pytest

import lqrrt_jax
from lqrrt_jax.models import double_integrator as di


@pytest.fixture(scope="module")
def planned():
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.2, max_time=6.0, printing=False,
        batch_size=64, capacity=2048, nn_block=256, seed=7,
        saturate=prob.get("saturate"))
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.15)
    return prob, planner, reached


def test_reaches_goal(planned):
    _, planner, reached = planned
    assert reached, f"goal not reached: {planner.stats}"
    assert planner.plan_reached_goal


def test_plan_nonempty_and_timed(planned):
    _, planner, _ = planned
    assert planner.x_seq is not None and len(planner.x_seq) > 1
    assert planner.T > 0
    assert len(planner.u_seq) == len(planner.x_seq) - 1


def test_plan_starts_at_x0(planned):
    prob, planner, _ = planned
    np.testing.assert_allclose(planner.x_seq[0], np.asarray(prob["x0"]),
                               atol=1e-5)


def test_plan_feasible_everywhere(planned):
    """Property: every plan state/effort passes is_feasible (SURVEY.md §4)."""
    prob, planner, _ = planned
    feas = prob["constraints"].is_feasible
    for x, u in zip(planner.x_seq[1:], planner.u_seq):
        assert bool(feas(jnp.asarray(x), jnp.asarray(u))), (
            f"infeasible plan point {x}, {u}")


def test_plan_dynamically_consistent(planned):
    """Consecutive plan states must obey the dynamics under the recorded
    efforts (within float tolerance) — i.e. the plan is executable."""
    prob, planner, _ = planned
    dyn = prob["dynamics"]
    x_seq, u_seq = planner.x_seq, planner.u_seq
    # pruning re-steers; junction discontinuities are bounded by error_tol,
    # so check one-step prediction error is small everywhere
    errs = []
    for k in range(len(u_seq)):
        xn = np.asarray(dyn(jnp.asarray(x_seq[k]), jnp.asarray(u_seq[k]),
                            prob["dt"]))
        errs.append(np.max(np.abs(xn - x_seq[k + 1])))
    assert np.median(errs) < 1e-3, f"median step error {np.median(errs)}"
    assert np.max(errs) < 0.2, f"max step error {np.max(errs)}"


def test_plan_ends_in_goal(planned):
    prob, planner, _ = planned
    e = np.abs(np.asarray(prob["goal"]) - planner.x_seq[-1])
    gb = np.asarray(prob["constraints"].goal_buffer)
    # pruning keeps the endpoint within the goal box (junction tol included)
    assert np.all(e <= gb + 0.1), f"end error {e} vs buffer {gb}"


def test_get_state_interpolation(planned):
    _, planner, _ = planned
    np.testing.assert_allclose(planner.get_state(0.0), planner.x_seq[0],
                               atol=1e-6)
    np.testing.assert_allclose(planner.get_state(1e9), planner.x_seq[-1],
                               atol=1e-6)
    mid = planner.get_state(planner.dt * 0.5)
    expect = 0.5 * (planner.x_seq[0] + planner.x_seq[1])
    np.testing.assert_allclose(mid, expect, atol=1e-5)
    # effort query: zero-order hold + clamp
    np.testing.assert_allclose(planner.get_effort(0.0), planner.u_seq[0])
    np.testing.assert_allclose(planner.get_effort(1e9), planner.u_seq[-1])


def test_kill_update_preempts():
    """kill_update takes effect at the next chunk boundary: once the kill
    flag is up, the planner must exit within ~one chunk's latency, not ride
    out the 60 s max_time (reference C10, SURVEY.md section 3.4)."""
    import time as _time
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=60.0, printing=False,
        batch_size=32, capacity=1024, nn_block=256)
    # warm the compile cache so the timed run measures chunk latency only
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.1,
                        pruning=False, specific_time=0.05)

    # update_plan unkills at entry (reference semantics), so kill via a
    # sys_time hook after the first few budget checks
    calls = {"n": 0}
    kill_t = {}

    def killing_clock():
        calls["n"] += 1
        if calls["n"] == 4:
            planner.kill_update()
            kill_t["t"] = _time.time()
        return _time.time()

    planner.sys_time = killing_clock
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.1,
                        pruning=False)
    # exit latency after the kill: bounded by one chunk of device work plus
    # extraction — far below a second of the 60 s budget on any backend
    assert "t" in kill_t, "kill hook never fired"
    assert _time.time() - kill_t["t"] < 5.0
    assert planner.x_seq is not None  # best-so-far salvage


def test_max_nodes_respected():
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=30.0, max_nodes=200, printing=False,
        batch_size=32, capacity=1024, nn_block=256)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.0,
                        pruning=False)
    # max_nodes is enforced at chunk granularity: overshoot is bounded by
    # one chunk's worth of commits (batch_size * rounds_per_chunk)
    assert planner.stats["nodes"] <= (
        200 + planner.batch_size * planner.rounds_per_chunk)


def test_guide_bias_used():
    prob = di.default_problem(obstacles=False)
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=5.0, printing=False,
        batch_size=32, capacity=512, nn_block=256, seed=3)
    guide = jnp.asarray([5.0, 3.0, 0.0, 0.0], jnp.float32)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.5,
                        guide=guide, pruning=False)
    assert planner.x_seq is not None


def test_specific_time_budget():
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=512, nn_block=256)
    import time as _time
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.1,
                        pruning=False, specific_time=0.5)
    t0 = _time.time()
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.1,
                        pruning=False, specific_time=0.5)
    # second call is compile-cache warm; budget should be ~respected
    assert _time.time() - t0 < 5.0


def test_fpr_warm_start_replans():
    """FPR > 0 resamples part of each batch from the previous committed plan
    (SURVEY.md 3.1 note: FPR semantics reconstructed as fraction-of-plan-
    retention).  Both the first call (straight-line pseudo-plan) and warm
    replans must work from ONE compiled chunk variant."""
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=20.0, printing=False, FPR=0.4,
        batch_size=64, capacity=1024, nn_block=256, seed=11,
        saturate=prob["saturate"])
    r1 = planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.15)
    assert r1, planner.stats
    first_plan = planner.x_seq.copy()
    # replan from 1 s along the committed plan: the warm start biases toward
    # the previous plan's corridor
    x1 = planner.get_state(1.0)
    r2 = planner.update_plan(x1, prob["sample_space"], goal_bias=0.15)
    assert r2, planner.stats
    assert len(planner._chunk_cache) == 1   # one compiled variant serves both
    assert planner.x_seq is not first_plan


def test_finish_on_goal_forces_exact_arrival():
    """finish_on_goal must land the plan far inside the goal box — the
    reference's force_arrive exact terminal connection (SURVEY.md C7).  The
    terminal steer runs at an extended horizon; merely stopping at the goal
    *buffer* boundary (the pre-fix behavior) fails this."""
    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.2, max_time=6.0, printing=False,
        batch_size=64, capacity=2048, nn_block=256, seed=11,
        saturate=prob.get("saturate"))
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.15, finish_on_goal=True)
    assert reached
    e = np.abs(np.asarray(prob["goal"]) - planner.x_seq[-1])
    gb = np.asarray(prob["constraints"].goal_buffer)
    # strictly tighter than the goal buffer: the exact connection converged
    # to error_tol (or the best-improving prefix got well inside the box)
    assert np.all(e <= 0.5 * gb), f"terminal error {e} vs buffer {gb}"


def test_refinement_after_capacity():
    """Once the tree saturates capacity, refine=True keeps the budget buying
    plan quality via anytime restarts: stash the best tree so far, reseed,
    keep growing, commit the min over all trees.  The
    committed plan must be monotone non-increasing in budget (guaranteed by
    construction: a longer budget's tree set is a superset), restarts must
    actually run, and the chosen tree must stay structurally valid."""
    prob = di.default_problem()

    def clock_factory(n_chunks):
        state = {"n": 0}

        def clock():
            state["n"] += 1
            return 0.0 if state["n"] <= n_chunks + 1 else 1e9
        return clock

    def run(refine, n_chunks):
        p = lqrrt_jax.Planner(
            prob["dynamics"], prob["lqr"], prob["constraints"],
            horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
            printing=False, batch_size=64, capacity=256, nn_block=128,
            saturate=prob["saturate"], seed=7, rounds_per_chunk=2,
            refine=refine)
        p.sys_time = clock_factory(n_chunks)
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                      pruning=False, specific_time=1.0)
        return p

    base = run(refine=False, n_chunks=40)   # stops at the node cap
    ref = run(refine=True, n_chunks=40)     # same grow prefix, then restarts
    assert base.stats["restarts"] == 0
    assert ref.stats["restarts"] > 0
    # the grow run saturates every tree row; "nodes" is the honest live
    # count (commit_all stores empty rollouts as inert duplicate rows)
    assert base.stats["tree_rows"] == 256
    assert 1 < base.stats["nodes"] <= 256
    assert base.plan_reached_goal and ref.plan_reached_goal
    # identical grow prefix (same seed/keys) => min over restarts can only
    # improve on the single saturated tree
    assert ref.stats["plan_duration_s"] <= base.stats["plan_duration_s"]

    # budget monotonicity at fixed seed: each longer run's restart set is a
    # superset of the shorter run's, so durations are non-increasing
    durs = [run(True, n).stats["plan_duration_s"] for n in (10, 25, 40)]
    assert durs[1] <= durs[0] + 1e-6 and durs[2] <= durs[1] + 1e-6, durs


def test_informed_restarts_never_hurt():
    """informed= corridor biasing (restart mechanism (b))
    at fixed seed/chunks: the informed run must commit a plan no longer than
    the uninformed run (both take the min over their restart stashes; the
    informed pool only changes later restarts' sampling), and the plan must
    stay feasible end-to-end."""
    prob = di.default_problem()

    def clock_factory(n_chunks):
        state = {"n": 0}

        def clock():
            state["n"] += 1
            return 0.0 if state["n"] <= n_chunks + 1 else 1e9
        return clock

    def run(informed):
        p = lqrrt_jax.Planner(
            prob["dynamics"], prob["lqr"], prob["constraints"],
            horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
            printing=False, batch_size=64, capacity=256, nn_block=128,
            saturate=prob["saturate"], seed=7, rounds_per_chunk=2,
            informed=informed)
        p.sys_time = clock_factory(40)
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                      pruning=False, specific_time=1.0)
        return p

    p0 = run(0.0)
    p1 = run(0.5)
    assert p0.plan_reached_goal and p1.plan_reached_goal
    assert p1.stats["restarts"] > 0
    # min-over-stashes with an identical uninformed prefix can only tie or
    # beat on the shared prefix; allow fp slop for the informed tail's
    # different draws
    assert p1.stats["plan_duration_s"] <= p0.stats["plan_duration_s"] + 0.5
    # the informed plan is dynamically consistent and feasible
    import jax
    xs = np.asarray(p1.x_seq)
    feas = prob["constraints"].is_feasible
    ok = np.asarray(jax.vmap(lambda x: feas(x, jnp.zeros(2)))(
        jnp.asarray(xs)))
    assert ok.all()

    # structural invariants of the chosen (possibly stashed) tree: acyclic
    # climb, consistent child counts, live parents
    t = p1._device_tree
    size = int(t.size)
    parent = np.asarray(t.parent)[:size]
    assert parent[0] == -1 and np.all(parent[1:] >= 0)
    assert np.all(parent[1:] < size)
    # child counts track only LIVE children: commit_all rows with a
    # zero-length edge are inert duplicates that never increment the count
    live = np.asarray(t.edge_len)[:size] >= 1
    counts = np.bincount(parent[1:][live[1:]], minlength=size)
    np.testing.assert_array_equal(counts,
                                  np.asarray(t.n_children)[:size])
    for start in range(size):          # every node climbs to the root
        seen, ID = 0, start
        while ID != -1:
            ID = int(parent[ID]) if ID else -1
            seen += 1
            assert seen <= size, "cycle in parent graph"


def test_dynamic_obstacles_zero_recompile():
    """Moving-obstacle replans via Constraints.set_feasibility_data: the
    obstacle field rides through the compiled chunk as a traced argument, so
    value updates cost ZERO recompiles (reference C9 dynamic obstacle swap)
    — and the updated field is actually honored."""
    from lqrrt_jax.constraints import Constraints
    from lqrrt_jax.ops.collision import circles_free_data

    prob = di.default_problem(obstacles=False)
    data0 = {"centers": np.array([[1.5, 0.0]], np.float32),
             "radii": np.array([0.6], np.float32)}
    cons = Constraints(nstates=4, ncontrols=2,
                       goal_buffer=prob["constraints"].goal_buffer,
                       is_feasible=circles_free_data(margin=0.05),
                       feasibility_data=data0)
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], cons, horizon=prob["horizon"],
        dt=prob["dt"], goal0=prob["goal"], printing=False, batch_size=64,
        capacity=512, nn_block=128, saturate=prob["saturate"], seed=2)
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, pruning=True,
                                  specific_time=2.0)
    assert reached
    # refine chunks may lazily compile whenever the tree hits capacity; only
    # a new grow/restart variant would indicate a feasibility retrace
    n_compiled = sum(1 for k in planner._chunk_cache
                     if k[3] in ("grow", "restart"))
    assert n_compiled == 1

    def min_clearance(p, c, r):
        d = np.linalg.norm(np.asarray(p.x_seq)[:, :2] - c, axis=1) - r
        return d.min()

    assert min_clearance(planner, data0["centers"][0], 0.6) > 0.0

    # the buoy moves: same shapes, new values -> same compiled chunks
    data1 = {"centers": np.array([[1.5, 0.35]], np.float32),
             "radii": np.array([0.7], np.float32)}
    cons.set_feasibility_data(data1)
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, pruning=True,
                                  specific_time=2.0)
    assert reached
    assert sum(1 for k in planner._chunk_cache
               if k[3] in ("grow", "restart")) == n_compiled  # zero retraces
    assert min_clearance(planner, data1["centers"][0], 0.7) > 0.0
    # and the new plan respects the NEW field, which the old one need not
    assert planner.plan_reached_goal


def test_feasibility_data_requires_ctor():
    from lqrrt_jax.constraints import Constraints
    cons = Constraints(nstates=4, ncontrols=2, goal_buffer=np.ones(4))
    import pytest
    with pytest.raises(ValueError, match="feasibility_data"):
        cons.set_feasibility_data({"x": np.zeros(3)})


def test_leaf_rewire_mode_refines_past_capacity():
    """refine_mode='leaf_rewire': once the tree fills,
    the budget runs leaf-replacement + rewiring chunks on the SAME tree —
    the refine chunk variant must actually engage, the plan must stay
    goal-reaching and feasible, and more budget must never lengthen the
    committed plan (on the near-equilibrium double integrator, where
    steering between stored states converges and rewiring can fire)."""
    prob = di.default_problem()

    def clock_factory(n_chunks):
        state = {"n": 0}

        def clock():
            state["n"] += 1
            return 0.0 if state["n"] <= n_chunks + 1 else 1e9
        return clock

    def run(n_chunks):
        p = lqrrt_jax.Planner(
            prob["dynamics"], prob["lqr"], prob["constraints"],
            horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
            printing=False, batch_size=64, capacity=256, nn_block=128,
            saturate=prob["saturate"], seed=7, rounds_per_chunk=2,
            refine_mode="leaf_rewire")
        p.sys_time = clock_factory(n_chunks)
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                      pruning=False, specific_time=1.0)
        return p

    short = run(10)
    long = run(40)
    assert short.plan_reached_goal and long.plan_reached_goal
    # the refine chunk variant was actually built and used
    assert any(k[3] == "refine" for k in long._chunk_cache), \
        list(long._chunk_cache)
    assert long.stats["restarts"] == 0          # same tree, no reseeds
    # identical prefix + in-place refinement => never worse with more budget
    assert long.stats["plan_duration_s"] <= \
        short.stats["plan_duration_s"] + 1e-6
    # plan stays feasible end to end
    import jax
    feas = prob["constraints"].is_feasible
    ok = np.asarray(jax.vmap(lambda x: feas(x, jnp.zeros(2)))(
        jnp.asarray(np.asarray(long.x_seq))))
    assert ok.all()


def test_depth_planting_solves_deep_instance():
    """Each restart cycle grows at most F = ceil(capacity/batch) edge
    generations; a goal needing more edges than F is unreachable by any
    single cycle.  The round-5 reseed policy PLANTS the stash's best chain
    prefix (always before the first goal; alternating afterwards), so
    successive cycles inherit depth and such instances solve (the two-wall
    hard boat was unsolvable at ANY budget without it).

    Deep double-integrator: capacity/batch = 2 generations per cycle, a
    short horizon, and a goal ~6+ edges away."""
    prob = di.default_problem()
    goal = np.asarray(prob["goal"]).copy()
    goal[0] = 30.0                        # far goal, short horizon below
    ss = np.asarray(prob["sample_space"]).copy()
    ss[0] = [-1.0, 33.0]
    calls = {"n": 0}

    def clock():                          # call-counted budget: 30 chunks
        calls["n"] += 1
        return 0.0 if calls["n"] <= 30 else 1e9

    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=1.0, dt=prob["dt"], goal0=goal, printing=False,
        batch_size=128, capacity=256, nn_block=128, seed=11,
        saturate=prob.get("saturate"), rounds_per_chunk=4)
    planner.sys_time = clock
    reached = planner.update_plan(prob["x0"], ss, goal_bias=0.2,
                                  pruning=False)
    assert reached, planner.stats
    # the committed plan really is deeper than one cycle's F=2 generations
    assert planner.stats["plan_duration_s"] > 2 * planner.horizon

"""Unit tests for sampling, nearest-neighbor, and steering primitives
(SURVEY.md section 4: argmin-NN vs brute force, rollout vs reference
integrator)."""
import numpy as np
import jax
import jax.numpy as jnp

from lqrrt_jax.core.nearest import make_nearest, goal_cost_to_go
from lqrrt_jax.core.sampling import normalize_goal_bias, sample_batch
from lqrrt_jax.core.steer import make_steer
from lqrrt_jax.ops.angles import make_erf, wrap_angle


def test_sample_batch_bounds_and_bias():
    key = jax.random.PRNGKey(0)
    space = jnp.array([[0.0, 1.0], [-2.0, 2.0]])
    goal = jnp.array([0.5, 0.0])
    xr = sample_batch(key, 4096, space, jnp.array([0.0, 0.0]), goal)
    a = np.asarray(xr)
    assert a[:, 0].min() >= 0.0 and a[:, 0].max() <= 1.0
    assert a[:, 1].min() >= -2.0 and a[:, 1].max() <= 2.0
    # full bias on dim 0 only
    xr = sample_batch(key, 512, space, jnp.array([1.0, 0.0]), goal)
    a = np.asarray(xr)
    np.testing.assert_allclose(a[:, 0], 0.5, atol=1e-6)
    assert a[:, 1].std() > 0.1


def test_normalize_goal_bias():
    gb = normalize_goal_bias(0.3, 4)
    np.testing.assert_allclose(np.asarray(gb), [0.3] * 4)
    gb = normalize_goal_bias([0.1, 0.2, 0.3, 0.4], 4)
    np.testing.assert_allclose(np.asarray(gb), [0.1, 0.2, 0.3, 0.4])


def test_nearest_matches_bruteforce():
    rng = np.random.default_rng(0)
    N, B, n = 512, 64, 4
    states = rng.standard_normal((N, n)).astype(np.float32)
    # random SPD metrics per node
    A = rng.standard_normal((N, n, n)).astype(np.float32)
    S = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(n, dtype=np.float32)
    xrand = rng.standard_normal((B, n)).astype(np.float32)
    size = 300  # only first 300 valid
    nearest = make_nearest(jnp.subtract, block=128)
    ids, costs = jax.jit(nearest)(jnp.array(states), jnp.array(S),
                                  jnp.asarray(size), jnp.array(xrand))
    e = xrand[:, None, :] - states[None, :size, :]
    brute = np.einsum("bin,inm,bim->bi", e, S[:size], e)
    np.testing.assert_array_equal(np.asarray(ids), brute.argmin(1))
    np.testing.assert_allclose(np.asarray(costs), brute.min(1), rtol=1e-4,
                               atol=1e-4)


def test_nearest_with_angle_wrap():
    erf = make_erf(2, angle_dims=(1,))
    states = jnp.array([[0.0, 3.0], [0.0, 0.0]])  # node0 angle 3 rad
    S = jnp.stack([jnp.eye(2)] * 2)
    nearest = make_nearest(erf, block=2)
    # sample at angle -3: wrapped distance to 3 is ~0.28, to 0 is 3
    ids, _ = nearest(states, S, jnp.asarray(2), jnp.array([[0.0, -3.0]]))
    assert int(ids[0]) == 0


def test_goal_cost_to_go():
    states = jnp.array([[0.0, 0.0], [1.0, 0.0]])
    S = jnp.stack([jnp.eye(2), 2 * jnp.eye(2)])
    goal = jnp.array([2.0, 0.0])
    c = np.asarray(goal_cost_to_go(jnp.subtract, states, S, goal))
    np.testing.assert_allclose(c, [4.0, 2.0])


def _di_dynamics(x, u, dt):
    # double integrator, euler for test readability
    return x + dt * jnp.concatenate([x[2:], u])


def test_steer_converges_to_target():
    n, m, H, dt = 4, 2, 200, 0.05
    K = jnp.array([[2.0, 0.0, 2.5, 0.0], [0.0, 2.0, 0.0, 2.5]])
    steer = make_steer(_di_dynamics, jnp.subtract,
                       lambda x, u: jnp.bool_(True), H, dt, 0.05)
    x0 = jnp.zeros((1, n))
    xtar = jnp.array([[1.0, -1.0, 0.0, 0.0]])
    res = steer(x0, K[None], xtar)
    assert bool(res.reached[0])
    ln = int(res.length[0])
    assert 0 < ln <= H
    # final state close to target
    np.testing.assert_allclose(np.asarray(res.xnew[0]), np.asarray(xtar[0]),
                               atol=0.06)
    # padded steps hold the last state
    np.testing.assert_allclose(np.asarray(res.x_seq[0, ln:]),
                               np.tile(np.asarray(res.xnew[0]), (H - ln, 1)))
    # mask marks exactly the first ln steps
    np.testing.assert_array_equal(np.asarray(res.mask[0]),
                                  [True] * ln + [False] * (H - ln))


def test_steer_matches_numpy_rollout():
    """Rollout vs a plain numpy reference integrator (SURVEY.md §4)."""
    n, H, dt = 4, 30, 0.05
    K = np.array([[1.5, 0.0, 2.0, 0.0], [0.0, 1.5, 0.0, 2.0]], np.float32)
    steer = make_steer(_di_dynamics, jnp.subtract,
                       lambda x, u: jnp.bool_(True), H, dt, 1e-6)
    x0 = np.array([0.0, 0.0, 0.5, -0.5], np.float32)
    xtar = np.array([2.0, 2.0, 0.0, 0.0], np.float32)
    res = steer(jnp.array(x0)[None], jnp.array(K)[None], jnp.array(xtar)[None])
    x = x0.copy()
    for k in range(H):
        e = xtar - x
        u = K @ e
        x = x + dt * np.concatenate([x[2:], u])
        np.testing.assert_allclose(np.asarray(res.x_seq[0, k]), x, rtol=2e-4,
                                   atol=2e-4)


def test_steer_truncates_on_infeasible():
    # wall at px > 0.5
    def feas(x, u):
        return x[0] <= 0.5
    steer = make_steer(_di_dynamics, jnp.subtract, feas, 100, 0.05, 0.01)
    K = jnp.array([[2.0, 0.0, 2.5, 0.0], [0.0, 2.0, 0.0, 2.5]])
    res = steer(jnp.zeros((1, 4)), K[None],
                jnp.array([[2.0, 0.0, 0.0, 0.0]]))
    assert not bool(res.reached[0])
    ln = int(res.length[0])
    assert 0 < ln < 100
    assert float(res.xnew[0, 0]) <= 0.5


def test_steer_goal_stop_first_entry():
    """goal_buffer= fuses first-entry goal truncation into the scan (C6):
    the rollout must stop at the FIRST step inside the
    goal box, length/in_goal/xnew must match the two-pass reference (sweep
    the plain rollout for the first committed in-goal step)."""
    n, H, dt = 4, 120, 0.05
    K = jnp.array([[2.0, 0.0, 2.5, 0.0], [0.0, 2.0, 0.0, 2.5]])
    gbuf = jnp.array([0.3, 0.3, 2.0, 2.0])
    goal = jnp.array([1.6, -1.2, 0.0, 0.0])
    feas = lambda x, u: jnp.bool_(True)  # noqa: E731
    plain = make_steer(_di_dynamics, jnp.subtract, feas, H, dt, 0.05)
    fused = make_steer(_di_dynamics, jnp.subtract, feas, H, dt, 0.05,
                       goal_buffer=gbuf)
    x0 = jnp.zeros((3, n))
    # target 0 passes through the goal box toward a farther point; target 1
    # converges inside the box; target 2 never enters it
    xtar = jnp.array([[3.2, -2.4, 0.0, 0.0],
                      [1.6, -1.2, 0.0, 0.0],
                      [-2.0, 2.0, 0.0, 0.0]])
    rp = plain(x0, jnp.tile(K[None], (3, 1, 1)), xtar)
    rf = fused(x0, jnp.tile(K[None], (3, 1, 1)), xtar, goal)

    # two-pass reference on the plain rollout
    hit = np.all(np.abs(np.asarray(goal) - np.asarray(rp.x_seq))
                 <= np.asarray(gbuf), axis=-1)
    steps = np.arange(H)[None, :]
    hit &= steps < np.asarray(rp.length)[:, None]
    any_hit = hit.any(axis=1)
    first = np.where(any_hit, hit.argmax(axis=1), 0)

    np.testing.assert_array_equal(np.asarray(rf.in_goal), any_hit)
    assert any_hit[0] and any_hit[1] and not any_hit[2]
    for b in range(3):
        if any_hit[b]:
            assert int(rf.length[b]) == first[b] + 1
            np.testing.assert_allclose(np.asarray(rf.xnew[b]),
                                       np.asarray(rp.x_seq[b, first[b]]),
                                       atol=1e-6)
        else:
            assert int(rf.length[b]) == int(rp.length[b])
    # prefix of the rollout identical to the plain steer
    ln0 = int(rf.length[0])
    np.testing.assert_allclose(np.asarray(rf.x_seq[0, :ln0]),
                               np.asarray(rp.x_seq[0, :ln0]), atol=1e-6)


def test_wrap_angle():
    np.testing.assert_allclose(float(wrap_angle(jnp.pi + 0.1)),
                               -jnp.pi + 0.1, atol=1e-6)
    np.testing.assert_allclose(float(wrap_angle(-jnp.pi - 0.1)),
                               jnp.pi - 0.1, atol=1e-6)
    np.testing.assert_allclose(float(wrap_angle(0.3)), 0.3, atol=1e-7)


def test_dense_commit_matches_scatter_commit():
    """commit_batch_dense (sort + dynamic_update_slice) must agree with the
    scatter commit on the valid region for any mix of valid/invalid/overflow
    candidates."""
    from lqrrt_jax.core.commit import commit_batch, commit_batch_dense
    from lqrrt_jax.core.tree import init_tree

    N, H, n, m, B = 16, 4, 3, 2, 8
    rng = np.random.default_rng(0)
    x0 = jnp.zeros(n)
    S0 = jnp.eye(n)
    K0 = jnp.zeros((m, n))
    t_sc = init_tree(N, H, n, m, x0, S0, K0, 5.0, False)
    t_de = init_tree(N, H, n, m, x0, S0, K0, 5.0, False, slack=B)
    # pre-grow both to size 13 so the batch overflows the capacity of 16
    size0 = 13
    t_sc = t_sc._replace(size=jnp.asarray(size0))
    t_de = t_de._replace(size=jnp.asarray(size0))

    pids = jnp.asarray(rng.integers(0, size0, B).astype(np.int32))
    length = jnp.asarray([0, 2, 4, 0, 1, 3, 2, 1], np.int32)  # 2 invalid
    x_seq = jnp.asarray(rng.normal(size=(H, n, B)).astype(np.float32))
    u_seq = jnp.asarray(rng.normal(size=(H, m, B)).astype(np.float32))
    xnew = jnp.asarray(rng.normal(size=(B, n)).astype(np.float32))
    S_new = jnp.tile(jnp.eye(n)[None], (B, 1, 1))
    K_new = jnp.zeros((B, m, n))
    in_goal = jnp.asarray([False, False, True, False, False, False, False,
                           False])
    gcost = jnp.asarray(rng.uniform(1, 9, B).astype(np.float32))

    out_sc = commit_batch(t_sc, 0.1, pids, length, x_seq, u_seq, xnew,
                          S_new, K_new, in_goal, gcost)
    out_de = commit_batch_dense(t_de, 0.1, N, pids, length, x_seq, u_seq,
                                xnew, S_new, K_new, in_goal, gcost)
    assert int(out_sc.size) == int(out_de.size) == 16   # 13 + 3 of 6 valid
    assert bool(out_sc.goal_found) == bool(out_de.goal_found)
    sz = int(out_sc.size)
    for f in ("state", "parent", "edge_len", "node_time", "goal_cost",
              "in_goal"):
        a = np.asarray(getattr(out_sc, f))[:sz]
        b = np.asarray(getattr(out_de, f))[:sz]
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("edge_x", "edge_u"):          # time-major: node axis is last
        a = np.asarray(getattr(out_sc, f))[..., :sz]
        b = np.asarray(getattr(out_de, f))[..., :sz]
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_refine_commit_leaf_replacement():
    """commit_batch_refine: best candidate replaces the worst replaceable
    leaf; interior nodes, goal nodes, this batch's parents, and the root are
    never victims; n_children stays consistent; size is unchanged."""
    from lqrrt_jax.core.commit import commit_batch_refine
    from lqrrt_jax.core.tree import init_tree

    N, H, n, m, B = 8, 2, 2, 1, 3
    t = init_tree(N, H, n, m, jnp.zeros(n), jnp.eye(n), jnp.zeros((m, n)),
                  50.0, False)
    # hand-build: 0 root -> {1, 2}; 1 -> {3, 4}; leaves 2 (bad), 3, 4 (goal)
    t = t._replace(
        size=jnp.asarray(5, jnp.int32),
        parent=t.parent.at[1:5].set(jnp.asarray([0, 0, 1, 1])),
        goal_cost=t.goal_cost.at[1:5].set(jnp.asarray([8.0, 10.0, 5.0, 0.5])),
        in_goal=t.in_goal.at[4].set(True),
        n_children=t.n_children.at[0].set(2).at[1].set(2),
        node_time=t.node_time.at[1:5].set(0.5),
        goal_found=jnp.asarray(True),
    )
    pids = jnp.asarray([3, 0, 1], jnp.int32)       # node 3 is a parent here
    length = jnp.asarray([1, 1, 0], jnp.int32)     # cand 2 invalid
    x_seq = jnp.ones((H, n, B))                    # time-major
    u_seq = jnp.ones((H, m, B))
    xnew = jnp.arange(B * n, dtype=jnp.float32).reshape(B, n) + 100.0
    S_new = jnp.tile(jnp.eye(n)[None], (B, 1, 1))
    K_new = jnp.zeros((B, m, n))
    in_goal = jnp.zeros(B, bool)
    gcost = jnp.asarray([1.0, 20.0, 0.1])          # cand 0 best valid

    out = commit_batch_refine(t, 0.1, N, pids, length, x_seq, u_seq, xnew,
                              S_new, K_new, in_goal, gcost)
    # only replaceable leaf is node 2 (3 is a batch parent, 4 is goal):
    # cand0 (gcost 1.0 < 10.0) takes slot 2; cand1 (20.0) loses; cand2 invalid
    assert int(out.size) == 5
    np.testing.assert_allclose(np.asarray(out.state[2]), np.asarray(xnew[0]))
    assert int(out.parent[2]) == 3
    assert float(out.goal_cost[2]) == 1.0
    np.testing.assert_allclose(float(out.node_time[2]), 0.6, atol=1e-6)
    # n_children: node 0 lost old leaf 2 (2->1), node 3 gained it (0->1)
    assert int(out.n_children[0]) == 1
    assert int(out.n_children[3]) == 1
    # untouched rows
    np.testing.assert_array_equal(np.asarray(out.parent[:2]),
                                  np.asarray(t.parent[:2]))
    assert bool(out.in_goal[4]) and bool(out.goal_found)
    # goal candidates always beat any non-goal leaf
    in_goal2 = jnp.asarray([True, False, False])
    out2 = commit_batch_refine(out, 0.1, N, pids, length, x_seq, u_seq, xnew,
                               S_new, K_new, in_goal2, gcost)
    # victim set is now {2} again (its gcost 1.0); goal cand score << 1.0
    assert bool(out2.in_goal[2])
    assert int(out2.size) == 5


def test_expand_truncates_at_first_goal_entry():
    """A rollout that passes THROUGH the goal box is cut at its first in-goal
    step: length drops below the horizon, the node lands inside the box, and
    time-to-goal gains dt resolution (core/rounds.py first-entry truncation;
    the reference tests only the endpoint, quantizing plan durations at
    horizon multiples)."""
    from lqrrt_jax.core.rounds import RoundSpec, make_expand
    from lqrrt_jax.core.tree import init_tree
    from lqrrt_jax.models import double_integrator as di

    prob = di.default_problem(obstacles=False)
    H = 80
    spec = RoundSpec(nstates=4, ncontrols=2, batch=4, horizon_steps=H,
                     capacity=64, dt=prob["dt"], nn_block=64)
    # goal halfway along the path to the steer target, velocity unconstrained
    goal = jnp.asarray([2.0, 0.0, 0.0, 0.0])
    buffer = jnp.asarray([0.4, 0.4, 50.0, 50.0])
    expand = make_expand(spec, prob["dynamics"], prob["lqr"], prob["erf"],
                         lambda x, u: jnp.bool_(True), 1e-4, buffer,
                         saturate=prob["saturate"])
    S0, K0 = prob["lqr"](None, None)
    tree = init_tree(64, H, 4, 2, jnp.zeros(4), S0, K0, 1e9, False)
    xrand = jnp.tile(jnp.asarray([6.0, 0.0, 0.0, 0.0])[None], (4, 1))
    c = jax.jit(expand)(tree, xrand, goal)

    length = np.asarray(c.length)
    assert bool(np.all(np.asarray(c.in_goal))), "rollout crosses the box"
    assert np.all(length < H), f"not truncated: {length}"
    # node state is inside the goal box...
    e = np.abs(np.asarray(goal) - np.asarray(c.xnew))
    assert np.all(e <= np.asarray(buffer) + 1e-6)
    # ...and is exactly the FIRST in-goal rollout step (x_seq time-major)
    xs = np.asarray(c.x_seq[:, :, 0])              # (H, n)
    inside = np.all(np.abs(np.asarray(goal) - xs) <= np.asarray(buffer),
                    axis=-1)
    assert int(length[0]) - 1 == int(np.argmax(inside))


def test_steer_bt_layout_matches_batch_leading():
    """layout="bt" (batch-trailing (n, B) scan carry, batch in the minor
    dimension) is a drop-in for the default layout: identical booleans/lengths,
    float outputs equal to contraction-order tolerance (core/steer.py)."""
    from lqrrt_jax.models import boat

    prob = boat.default_problem()
    H, dt = 60, 0.05
    kw = dict(saturate=prob["saturate"],
              goal_buffer=prob["constraints"].goal_buffer)
    mk = lambda layout: jax.jit(make_steer(  # noqa: E731
        prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
        H, dt, 0.05, layout=layout, **kw))
    B = 48
    key = jax.random.PRNGKey(3)
    x0 = jax.random.uniform(key, (B, 6), minval=-1.0, maxval=1.0)
    _, K = prob["lqr"](None, None)
    Kb = jnp.tile(K[None], (B, 1, 1))
    xtar = jax.random.uniform(jax.random.fold_in(key, 1), (B, 6),
                              minval=-3.0, maxval=3.0)
    goal = jnp.asarray(prob["goal"])
    ra = mk("b")(x0, Kb, xtar, goal)
    rb = mk("bt")(x0, Kb, xtar, goal)
    for f in ("mask", "length", "reached", "in_goal"):
        np.testing.assert_array_equal(np.asarray(getattr(ra, f)),
                                      np.asarray(getattr(rb, f)), err_msg=f)
    for f in ("x_seq", "u_seq", "xnew"):
        np.testing.assert_allclose(np.asarray(getattr(ra, f)),
                                   np.asarray(getattr(rb, f)),
                                   rtol=1e-4, atol=1e-3, err_msg=f)


def test_commit_all_matches_dense_on_valid_rows():
    """commit_batch_dense_all (sort/gather-free) keeps every VALID candidate
    with data identical to the sorted dense commit; invalid rows become
    zero-length duplicates of their parent that are inert: in_goal False,
    no child-count contribution, goal_found unchanged."""
    from lqrrt_jax.core.commit import commit_batch_dense, commit_batch_dense_all
    from lqrrt_jax.core.tree import init_tree

    N, H, n, m, B = 32, 4, 3, 2, 8
    rng = np.random.default_rng(1)
    x0 = jnp.zeros(n)
    t_de = init_tree(N, H, n, m, x0, jnp.eye(n), jnp.zeros((m, n)), 5.0,
                     False, slack=B)
    t_al = init_tree(N, H, n, m, x0, jnp.eye(n), jnp.zeros((m, n)), 5.0,
                     False, slack=B)
    size0 = 5
    t_de = t_de._replace(size=jnp.asarray(size0))
    t_al = t_al._replace(size=jnp.asarray(size0))

    pids = jnp.asarray(rng.integers(0, size0, B).astype(np.int32))
    length = jnp.asarray([0, 2, 4, 0, 1, 3, 2, 1], np.int32)  # 2 invalid
    x_seq = jnp.asarray(rng.normal(size=(H, n, B)).astype(np.float32))
    u_seq = jnp.asarray(rng.normal(size=(H, m, B)).astype(np.float32))
    xnew = jnp.asarray(rng.normal(size=(B, n)).astype(np.float32))
    S_new = jnp.tile(jnp.eye(n)[None], (B, 1, 1))
    K_new = jnp.zeros((B, m, n))
    in_goal = jnp.asarray([False, False, True, False, False, False, False,
                           False])
    gcost = jnp.asarray(rng.uniform(1, 9, B).astype(np.float32))

    de = commit_batch_dense(t_de, 0.1, N, pids, length, x_seq, u_seq, xnew,
                            S_new, K_new, in_goal, gcost)
    al = commit_batch_dense_all(t_al, 0.1, N, pids, length, x_seq, u_seq,
                                xnew, S_new, K_new, in_goal, gcost)
    assert int(al.size) == size0 + B            # every row lands
    assert bool(al.goal_found) == bool(de.goal_found) is True
    # valid rows carry identical data in both commits (order may differ):
    # compare as multisets keyed by (state, edge_len)
    val = np.asarray(length) >= 1
    a_rows = {}
    for i in range(B):
        r = size0 + i
        row = (np.asarray(al.edge_len[r]).item(),
               tuple(np.round(np.asarray(al.state[r]), 5)))
        a_rows.setdefault(row, 0)
        a_rows[row] += 1
        if not val[i]:
            # invalid row: zero-length duplicate, inert
            assert int(al.edge_len[r]) == 0
            assert not bool(al.in_goal[r])
    de_rows = {}
    for r in range(size0, int(de.size)):
        row = (np.asarray(de.edge_len[r]).item(),
               tuple(np.round(np.asarray(de.state[r]), 5)))
        de_rows.setdefault(row, 0)
        de_rows[row] += 1
    for row, cnt in de_rows.items():
        assert a_rows.get(row, 0) >= cnt, row
    # child counts: only valid rows contribute
    expect = np.zeros(N + B, np.int64)
    for i in np.flatnonzero(val):
        expect[int(pids[i])] += 1
    got = np.asarray(al.n_children)[: N + B].astype(np.int64)
    base = np.zeros(N + B, np.int64)
    np.testing.assert_array_equal(got - base, expect)

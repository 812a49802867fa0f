"""Unit tests for core/rewire.py: pointer-doubling time recomputation and the
batched choose-parent rewire pass (SURVEY.md C2/C7 anytime refinement).

Rewire acceptance is convergence-gated (||erf(target, endpoint)|| <=
error_tol), which can genuinely fire only for near-equilibrium targets — the
double-integrator rest states used here.  See core/rewire.py and planner.py
for why the production anytime path uses restart-stash instead.
"""
import numpy as np
import jax
import jax.numpy as jnp

from lqrrt_jax.core.rewire import (make_nearest_pred, make_rewire,
                                   recompute_node_times)
from lqrrt_jax.core.rounds import RoundSpec
from lqrrt_jax.core.tree import init_tree


def test_recompute_node_times_matches_host_reference():
    rng = np.random.default_rng(0)
    N = 257
    parent = np.full(N, -1, np.int32)
    edge_len = np.zeros(N, np.int32)
    # random forest rooted at 0 with rows [1, 200) live, deep chains allowed
    for i in range(1, 200):
        parent[i] = rng.integers(0, i)
        edge_len[i] = rng.integers(1, 40)
    dt = 0.05
    got = np.asarray(recompute_node_times(jnp.asarray(parent),
                                          jnp.asarray(edge_len), dt))
    want = np.zeros(N, np.float32)
    for i in range(1, 200):     # parents precede children by construction
        want[i] = want[parent[i]] + edge_len[i] * dt
    np.testing.assert_allclose(got[:200], want[:200], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[200:], 0.0)


def test_recompute_node_times_deep_chain():
    # depth == N-1 (worst case for pointer doubling)
    N = 64
    parent = np.arange(-1, N - 1, dtype=np.int32)
    edge_len = np.ones(N, np.int32)
    edge_len[0] = 0
    got = np.asarray(recompute_node_times(jnp.asarray(parent),
                                          jnp.asarray(edge_len), 0.1))
    np.testing.assert_allclose(got, 0.1 * np.arange(N), rtol=1e-5, atol=1e-5)


def test_nearest_pred_masks():
    erf = jnp.subtract
    nearest = make_nearest_pred(erf, block=8)
    states = jnp.asarray(np.array(
        [[0.0, 0], [1, 0], [2, 0], [3, 0], [10, 10], [0, 0], [0, 0], [0, 0]],
        np.float32))
    S = jnp.broadcast_to(jnp.eye(2), (8, 2, 2))
    node_time = jnp.asarray([0.0, 1.0, 2.0, 3.0, 0.5, 0, 0, 0])
    live = jnp.asarray(5)
    x_t = states[3][None]          # target = node 3 (time 3.0)
    time_t = node_time[3][None]
    # node 2 is nearest and a time-predecessor, but excluded as the parent;
    # node 1 is the nearest remaining predecessor
    src, cost = jax.jit(nearest)(states, S, node_time, live, x_t, time_t,
                                 jnp.asarray([2]), 0.05)
    assert int(src[0]) == 1
    # target itself (time 3.0) excluded by the strict time mask even though
    # its distance is 0; dead rows (>= live) excluded
    src2, _ = jax.jit(nearest)(states, S, node_time, live, x_t, time_t,
                               jnp.asarray([-1]), 0.05)
    assert int(src2[0]) == 2


def _di_dynamics(x, u, dt):
    return x + dt * jnp.concatenate([x[2:], u])


_K = jnp.array([[2.0, 0.0, 2.5, 0.0], [0.0, 2.0, 0.0, 2.5]], jnp.float32)
_S = jnp.eye(4, dtype=jnp.float32)


def _lqr(x, u):
    return _S, _K


def _build_detour_tree(spec):
    """root -> A -> B with inflated edge times; steering root -> B converges
    (B is a rest state), so rewiring B onto the root must fire."""
    n, m, H = spec.nstates, spec.ncontrols, spec.horizon_steps
    x0 = jnp.zeros(n)
    tree = init_tree(spec.capacity, H, n, m, x0, _S, _K, 1e3, False,
                     slack=spec.slack)
    f32, i32 = jnp.float32, jnp.int32

    def add(tree, idx, state, parent, steps):
        return tree._replace(
            state=tree.state.at[idx].set(state),
            S=tree.S.at[idx].set(_S),
            K=tree.K.at[idx].set(_K),
            parent=tree.parent.at[idx].set(parent),
            edge_x=tree.edge_x.at[:, :, idx].set(
                jnp.broadcast_to(state, (H, n))),   # time-major (H, n, N)
            edge_len=tree.edge_len.at[idx].set(steps),
            node_time=tree.node_time.at[idx].set(
                tree.node_time[parent] + steps * spec.dt),
            goal_cost=tree.goal_cost.at[idx].set(1e3),
            n_children=tree.n_children.at[parent].add(1),
            size=jnp.asarray(idx + 1, i32))

    tree = add(tree, 1, jnp.asarray([4.0, 3.0, 0, 0], f32), 0, 100)  # A t=5
    tree = add(tree, 2, jnp.asarray([1.0, 0.0, 0, 0], f32), 1, 100)  # B t=10
    tree = add(tree, 3, jnp.asarray([1.5, 0.0, 0, 0], f32), 2, 40)   # C t=12
    return tree


def test_rewire_reparents_and_propagates():
    spec = RoundSpec(nstates=4, ncontrols=2, batch=8, horizon_steps=200,
                     capacity=64, dt=0.05, nn_block=64, slack=0)
    feas = lambda x, u: jnp.bool_(True)  # noqa: E731
    rewire = jax.jit(make_rewire(spec, _di_dynamics, _lqr, jnp.subtract,
                                 feas, 0.05, batch=8))
    tree = _build_detour_tree(spec)
    t_before = np.asarray(tree.node_time)[:4].copy()
    out = rewire(tree, jax.random.PRNGKey(0))

    parent = np.asarray(out.parent)
    node_time = np.asarray(out.node_time)
    # B (row 2) must have been re-parented onto the root with a shorter
    # arrival (root -> (1,0,0,0) converges well inside 10 s)
    assert parent[2] == 0, parent[:4]
    assert node_time[2] < t_before[2] - 0.5
    # every live node's time is consistent with its (possibly new) parent —
    # descendants of rewired nodes inherit the gain exactly
    edge_len = np.asarray(out.edge_len)
    for i in range(1, 4):
        np.testing.assert_allclose(
            node_time[i], node_time[parent[i]] + edge_len[i] * spec.dt,
            rtol=1e-5)
    assert node_time[3] < t_before[3]    # C inherited (or found) a gain
    # states never change; child counts stay consistent
    np.testing.assert_allclose(np.asarray(out.state)[:4],
                               np.asarray(tree.state)[:4])
    n_children = np.asarray(out.n_children)
    want = np.zeros_like(n_children)
    for i in range(1, 4):
        want[parent[i]] += 1
    np.testing.assert_array_equal(n_children[:4], want[:4])
    # acyclicity: climbing from every live node terminates at the root
    for i in range(4):
        seen, j = set(), i
        while j != -1:
            assert j not in seen
            seen.add(j)
            j = int(parent[j])
    # edge continuity contract: the new edge endpoint is within error_tol
    ln = int(np.asarray(out.edge_len)[2])
    end = np.asarray(out.edge_x)[ln - 1, :, 2]     # time-major (H, n, N)
    assert np.linalg.norm(end - np.asarray(tree.state)[2]) <= 0.05 + 1e-6


def test_rewire_noop_on_tiny_tree():
    spec = RoundSpec(nstates=4, ncontrols=2, batch=4, horizon_steps=50,
                     capacity=16, dt=0.05, nn_block=16, slack=0)
    feas = lambda x, u: jnp.bool_(True)  # noqa: E731
    rewire = jax.jit(make_rewire(spec, _di_dynamics, _lqr, jnp.subtract,
                                 feas, 0.05, batch=4))
    tree = init_tree(spec.capacity, 50, 4, 2, jnp.zeros(4), _S, _K, 1e3,
                     False, slack=0)
    out = rewire(tree, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(out.parent),
                                  np.asarray(tree.parent))
    assert int(out.size) == 1

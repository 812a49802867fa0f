"""Host Tree (reference-parity API) and device TreeArrays unit tests."""
import numpy as np
import jax.numpy as jnp

from lqrrt_jax.tree import Tree
from lqrrt_jax.core.tree import best_node, init_tree


def _mk_host_tree():
    t = Tree(np.zeros(2), (np.eye(2), np.ones((1, 2))))
    # chain 0 -> 1 -> 2, plus branch 0 -> 3
    t.add_node(0, [1.0, 0.0], (np.eye(2), np.ones((1, 2))),
               x_seq=[[0.5, 0.0], [1.0, 0.0]], u_seq=[[0.1], [0.1]])
    t.add_node(1, [2.0, 0.0], (np.eye(2), np.ones((1, 2))),
               x_seq=[[1.5, 0.0], [2.0, 0.0]], u_seq=[[0.2], [0.2]])
    t.add_node(0, [0.0, 1.0], (np.eye(2), np.ones((1, 2))),
               x_seq=[[0.0, 1.0]], u_seq=[[0.3]])
    return t


def test_host_tree_climb():
    t = _mk_host_tree()
    assert t.climb(2) == [0, 1, 2]
    assert t.climb(3) == [0, 3]
    assert t.climb(0) == [0]
    assert t.size == 4


def test_host_tree_trajectory():
    t = _mk_host_tree()
    xs, us = t.trajectory(t.climb(2))
    np.testing.assert_allclose(xs, [[0.5, 0], [1, 0], [1.5, 0], [2, 0]])
    np.testing.assert_allclose(us, [[0.1], [0.1], [0.2], [0.2]])


def test_host_tree_bad_parent():
    t = _mk_host_tree()
    import pytest
    with pytest.raises(IndexError):
        t.add_node(99, [0, 0], None, [[0, 0]], [[0]])


def test_init_tree_and_best_node():
    x0 = jnp.zeros(2)
    tree = init_tree(capacity=8, horizon_steps=4, nstates=2, ncontrols=1,
                     x0=x0, S0=jnp.eye(2), K0=jnp.ones((1, 2)),
                     goal_cost0=5.0, in_goal0=False)
    assert int(tree.size) == 1
    assert int(best_node(tree)) == 0
    # add a fake better node by hand
    tree = tree._replace(
        state=tree.state.at[1].set(jnp.array([1.0, 1.0])),
        goal_cost=tree.goal_cost.at[1].set(0.5),
        parent=tree.parent.at[1].set(0),
        size=jnp.asarray(2),
    )
    assert int(best_node(tree)) == 1
    # goal nodes beat cost heuristic; min node_time among them wins
    tree = tree._replace(
        in_goal=tree.in_goal.at[0].set(True),
        node_time=tree.node_time.at[0].set(3.0),
        goal_found=jnp.asarray(True),
    )
    assert int(best_node(tree)) == 0


def test_valid_mask():
    tree = init_tree(capacity=8, horizon_steps=2, nstates=2, ncontrols=1,
                     x0=jnp.zeros(2), S0=jnp.eye(2), K0=jnp.ones((1, 2)),
                     goal_cost0=1.0, in_goal0=False)
    np.testing.assert_array_equal(np.asarray(tree.valid_mask()),
                                  [True] + [False] * 7)


def test_host_tree_snapshot_consistent():
    """Planner.get_tree snapshots the device SoA into the reference-shaped
    host Tree: climb + trajectory must reconstruct a consistent branch."""
    import lqrrt_jax
    from lqrrt_jax.models import double_integrator as di

    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=10.0, printing=False, batch_size=32,
        capacity=256, nn_block=128, seed=4)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=1.0, pruning=False)
    t = planner.get_tree()
    assert t.size > 1
    assert len(t.pID) == t.size == len(t.x_seq) == len(t.lqr)
    np.testing.assert_allclose(t.state[0], np.asarray(prob["x0"]), atol=1e-6)
    # every node's incoming edge ends at the node's state
    for i in range(1, t.size):
        assert 0 <= t.pID[i] < i or t.pID[i] >= 0
        np.testing.assert_allclose(t.x_seq[i][-1], t.state[i], atol=1e-5)
    # climb from the last node reaches the root
    chain = t.climb(t.size - 1)
    assert chain[0] == 0 and chain[-1] == t.size - 1
    xs, us = t.trajectory(chain)
    np.testing.assert_allclose(xs[-1], t.state[t.size - 1], atol=1e-5)
    assert len(xs) == len(us) + sum(1 for ID in chain if ID == 0) \
        or len(xs) >= len(us)

"""Device-resident SoA tree: the replacement for the reference's pointer
tree.

Reference: lqrrt/tree.py class Tree — parallel lists grown per insert, states
in a growing numpy array, per-node (S, K), per-edge rollout sequences, parent
IDs (SURVEY.md C8).  Here dynamic growth is replaced by fixed-capacity
preallocated device arrays with a size scalar and capacity masking
(BASELINE.json: "tree storage: pointer tree -> preallocated device arrays with
parent indices"), so every expansion round is a static-shape jitted program.

The host-facing, reference-compatible ``Tree`` class lives in
lqrrt_jax/tree.py; this module is the device representation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class TreeArrays(NamedTuple):
    """All per-node storage, fixed capacity N; valid rows are [0, size)."""
    state: jnp.ndarray      # (N, n)  node states
    S: jnp.ndarray          # (N, n, n)  per-node LQR cost-to-go (NN metric)
    K: jnp.ndarray          # (N, m, n)  per-node LQR feedback gain
    parent: jnp.ndarray     # (N,) int32, parent index; root = -1
    # Edge rollouts are stored TIME-MAJOR, node index minor: (H, n, N) /
    # (H, m, N).  This matches the steer scan's natural (H, ·, B) output
    # stacking, so a round's commit is a single dynamic_update_slice on the
    # minor axis with NO relayout of the (H, n, B) rollout block.
    edge_x: jnp.ndarray     # (H, n, N)  rollout states of the incoming edge
    edge_u: jnp.ndarray     # (H, m, N)  rollout efforts of the incoming edge
    edge_len: jnp.ndarray   # (N,) int32, valid steps of the incoming edge
    node_time: jnp.ndarray  # (N,) f32, trajectory duration root -> node
    in_goal: jnp.ndarray    # (N,) bool, node satisfies the goal box
    goal_cost: jnp.ndarray  # (N,) f32, e' S e cost-to-go toward current goal
    n_children: jnp.ndarray  # (N,) int32, child count (0 = replaceable leaf)
    size: jnp.ndarray       # () int32, number of valid nodes
    goal_found: jnp.ndarray  # () bool, any(in_goal)

    @property
    def capacity(self) -> int:
        return self.state.shape[0]

    def valid_mask(self) -> jnp.ndarray:
        return jnp.arange(self.capacity) < self.size


def init_tree(capacity: int, horizon_steps: int, nstates: int, ncontrols: int,
              x0, S0, K0, goal_cost0, in_goal0, slack: int = 0) -> TreeArrays:
    """Seed a fresh tree with the root node x0 (reference: update_plan seeds
    Tree(seed_state=x0, seed_lqr=(S0, K0)), SURVEY.md section 3.2).

    ``slack`` allocates spare rows past the logical capacity for the
    scatter-free dense commit (core/commit.py commit_batch_dense); slack rows
    are never counted in ``size``."""
    N, H, n, m = capacity + slack, horizon_steps, nstates, ncontrols
    f32, i32 = jnp.float32, jnp.int32
    return TreeArrays(
        state=jnp.zeros((N, n), f32).at[0].set(x0),
        S=jnp.zeros((N, n, n), f32).at[0].set(S0),
        K=jnp.zeros((N, m, n), f32).at[0].set(K0),
        parent=jnp.full((N,), -1, i32),
        edge_x=jnp.zeros((H, n, N), f32),
        edge_u=jnp.zeros((H, m, N), f32),
        edge_len=jnp.zeros((N,), i32),
        node_time=jnp.zeros((N,), f32),
        in_goal=jnp.zeros((N,), bool).at[0].set(in_goal0),
        goal_cost=jnp.full((N,), jnp.inf, f32).at[0].set(goal_cost0),
        n_children=jnp.zeros((N,), i32),
        size=jnp.asarray(1, i32),
        goal_found=jnp.asarray(in_goal0, bool),
    )


def best_node(tree: TreeArrays) -> jnp.ndarray:
    """Best-branch selection (reference: goal-reaching node if any, else
    argmin of S-weighted cost-to-go toward goal; SURVEY.md C7).

    Among goal nodes, minimize trajectory duration (anytime refinement
    criterion); otherwise minimize the LQR cost-to-go heuristic.
    """
    valid = tree.valid_mask()
    goal_nodes = tree.in_goal & valid
    t_masked = jnp.where(goal_nodes, tree.node_time, jnp.inf)
    c_masked = jnp.where(valid, tree.goal_cost, jnp.inf)
    return jnp.where(tree.goal_found,
                     jnp.argmin(t_masked), jnp.argmin(c_masked))

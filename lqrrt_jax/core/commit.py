"""Masked compacting batch-commit of steered candidates into the SoA tree.

Factored out of the round so both the single-chip round (core/rounds.py) and
the multi-device sharded round (parallel/sharded.py) insert candidates through
the exact same code path (SURVEY.md section 7: "commit the surviving best
edges into preallocated tree arrays").

Two grow implementations with identical semantics:

* ``commit_batch`` — masked scatter (`.at[slot].set(..., mode="drop")`).
  General; the fallback when the tree has no slack rows.
* ``commit_batch_dense`` — stable-sort candidates valid-first, gather into a
  contiguous block, ONE dynamic_update_slice at row ``size``.  Vectorized
  writes, no scatter.  Requires the tree arrays to carry ``slack >= batch``
  spare rows past the logical ``limit`` (init_tree(slack=...)) so the
  B-row slice starting at size <= limit never lands out of bounds; spare/
  overflow rows are never counted in ``size`` and always get overwritten by
  the next commit before they could become live.

Plus the capacity-saturated policy:

* ``commit_batch_refine`` — leaf replacement once the tree is full, so the
  anytime budget keeps buying plan quality instead of stopping at the HBM
  cap (the reference never stops refining until max_nodes/budget; SURVEY.md
  C2).  Best candidates replace worst replaceable leaves, score-matched.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .tree import TreeArrays


def commit_batch(tree: TreeArrays, dt: float, pids, length, x_seq, u_seq,
                 xnew, S_new, K_new, in_goal, gcost) -> TreeArrays:
    """Insert every candidate with a non-empty rollout (reference semantics:
    "if rollout nonempty: tree.add_node", SURVEY.md section 3.2).

    Candidates that would overflow capacity are dropped via scatter-drop
    indexing; ``size`` saturates at capacity.  Per-candidate inputs are
    batch-leading; x_seq/u_seq are TIME-MAJOR (H, ·, B) matching the tree's
    edge storage (core/tree.py).
    """
    N = tree.capacity
    valid = length >= 1
    offs = jnp.cumsum(valid) - 1
    pos = tree.size + offs
    ok = valid & (pos < N)
    slot = jnp.where(ok, pos, N).astype(jnp.int32)     # N => dropped
    drop = dict(mode="drop")

    node_time = tree.node_time[pids] + length.astype(jnp.float32) * dt
    new_size = tree.size + jnp.sum(ok, dtype=jnp.int32)
    pid_slot = jnp.where(ok, pids.astype(jnp.int32), N)

    return tree._replace(
        state=tree.state.at[slot].set(xnew, **drop),
        S=tree.S.at[slot].set(S_new, **drop),
        K=tree.K.at[slot].set(K_new, **drop),
        parent=tree.parent.at[slot].set(pids.astype(jnp.int32), **drop),
        edge_x=tree.edge_x.at[:, :, slot].set(x_seq, **drop),
        edge_u=tree.edge_u.at[:, :, slot].set(u_seq, **drop),
        edge_len=tree.edge_len.at[slot].set(length, **drop),
        node_time=tree.node_time.at[slot].set(node_time, **drop),
        in_goal=tree.in_goal.at[slot].set(in_goal, **drop),
        goal_cost=tree.goal_cost.at[slot].set(gcost, **drop),
        n_children=tree.n_children.at[pid_slot].add(1, **drop),
        size=new_size,
        goal_found=tree.goal_found | jnp.any(in_goal & ok),
    )


def commit_batch_dense(tree: TreeArrays, dt: float, limit: int, pids, length,
                       x_seq, u_seq, xnew, S_new, K_new, in_goal,
                       gcost) -> TreeArrays:
    """Scatter-free commit (see module docstring).  ``limit`` is the logical
    capacity; tree arrays must be allocated with >= batch rows of slack."""
    B = pids.shape[0]
    valid = length >= 1
    # stable sort, valid candidates first; gathers keep the block contiguous
    order = jnp.argsort(jnp.logical_not(valid), stable=True)
    n_valid = jnp.sum(valid, dtype=jnp.int32)
    start = jnp.minimum(tree.size, jnp.asarray(limit, jnp.int32))
    rank = jnp.arange(B, dtype=jnp.int32)
    committed = (rank < n_valid) & (start + rank < limit)

    pids_s = pids.astype(jnp.int32)[order]
    length_s = length[order]
    in_goal_s = in_goal[order]
    node_time = tree.node_time[pids_s] + length_s.astype(jnp.float32) * dt

    def dus(a, block):
        idx = (start,) + (jnp.asarray(0, jnp.int32),) * (a.ndim - 1)
        return jax.lax.dynamic_update_slice(a, block, idx)

    def dus_tm(a, block):
        # time-major edge arrays: the node axis is MINOR (core/tree.py)
        zero = jnp.asarray(0, jnp.int32)
        return jax.lax.dynamic_update_slice(a, block, (zero, zero, start))

    new_size = jnp.minimum(tree.size + n_valid,
                           jnp.asarray(limit, jnp.int32))
    # child counting is the one scatter left: a 1-int-per-row add (cheap next
    # to the 10 wide row scatters the dense slice replaces)
    N = tree.state.shape[0]
    pid_slot = jnp.where(committed, pids_s, N)
    return tree._replace(
        state=dus(tree.state, xnew[order]),
        S=dus(tree.S, S_new[order]),
        K=dus(tree.K, K_new[order]),
        parent=dus(tree.parent, pids_s),
        edge_x=dus_tm(tree.edge_x, x_seq[:, :, order]),
        edge_u=dus_tm(tree.edge_u, u_seq[:, :, order]),
        edge_len=dus(tree.edge_len, length_s),
        node_time=dus(tree.node_time, node_time),
        in_goal=dus(tree.in_goal, in_goal_s),
        goal_cost=dus(tree.goal_cost, gcost[order]),
        n_children=tree.n_children.at[pid_slot].add(1, mode="drop"),
        size=new_size,
        goal_found=tree.goal_found | jnp.any(in_goal_s & committed),
    )


def commit_batch_dense_all(tree: TreeArrays, dt: float, limit: int, pids,
                           length, x_seq, u_seq, xnew, S_new, K_new, in_goal,
                           gcost) -> TreeArrays:
    """Sort-free, gather-free dense commit: ALL B candidate rows (empty
    rollouts included) land contiguously at row ``size``, one
    dynamic_update_slice per array, in raw batch order.

    An empty-rollout row (length == 0) is a zero-length-edge DUPLICATE of
    its parent: the steer never committed a step, so xnew is the parent's
    state and (S, K) the parent's policy re-solved at the same point.  Such
    rows are semantically inert — the NN metric scores them identically to
    the parent (steering from either is the same computation), extraction
    contributes zero steps for a zero-length edge, in_goal is masked false,
    and they are excluded from the parent's child count — at the price of
    occupying one capacity row each.  In exchange the hot path drops the
    valid-first argsort and the ~30 MB of reorder gathers on the edge
    arrays that commit_batch_dense pays every round.
    """
    B = pids.shape[0]
    N = tree.state.shape[0]
    valid = length >= 1
    start = jnp.minimum(tree.size, jnp.asarray(limit, jnp.int32))
    rank = jnp.arange(B, dtype=jnp.int32)
    committed = start + rank < limit
    pids_i = pids.astype(jnp.int32)
    node_time = tree.node_time[pids_i] + length.astype(jnp.float32) * dt
    in_goal_c = in_goal & valid

    def dus(a, block):
        idx = (start,) + (jnp.asarray(0, jnp.int32),) * (a.ndim - 1)
        return jax.lax.dynamic_update_slice(a, block, idx)

    def dus_tm(a, block):
        # time-major edge arrays: the node axis is MINOR (core/tree.py)
        zero = jnp.asarray(0, jnp.int32)
        return jax.lax.dynamic_update_slice(a, block, (zero, zero, start))

    new_size = jnp.minimum(tree.size + B, jnp.asarray(limit, jnp.int32))
    pid_slot = jnp.where(committed & valid, pids_i, N)
    return tree._replace(
        state=dus(tree.state, xnew),
        S=dus(tree.S, S_new),
        K=dus(tree.K, K_new),
        parent=dus(tree.parent, pids_i),
        edge_x=dus_tm(tree.edge_x, x_seq),
        edge_u=dus_tm(tree.edge_u, u_seq),
        edge_len=dus(tree.edge_len, length),
        node_time=dus(tree.node_time, node_time),
        in_goal=dus(tree.in_goal, in_goal_c),
        goal_cost=dus(tree.goal_cost, gcost),
        n_children=tree.n_children.at[pid_slot].add(1, mode="drop"),
        size=new_size,
        goal_found=tree.goal_found | jnp.any(in_goal_c & committed),
    )


_GOAL_OFFSET = 1e9   # goal-reaching candidates outrank any cost-to-go score


def commit_batch_refine(tree: TreeArrays, dt: float, limit: int, pids, length,
                        x_seq, u_seq, xnew, S_new, K_new, in_goal,
                        gcost) -> TreeArrays:
    """Leaf-replacement commit for a capacity-saturated tree.

    Policy: rank candidates best-first (goal-reaching first by root->node
    time, then ascending LQR cost-to-go); rank *replaceable* leaves worst-
    first (descending cost-to-go).  Pair k-th best candidate with k-th worst
    leaf and replace iff the candidate's score strictly beats the leaf's.
    ``size`` is unchanged; every replacement strictly improves the tree's
    score multiset, so refinement rounds monotonically improve plan quality.

    A row is replaceable iff it is live, not the root, not goal-reaching,
    has no children (n_children == 0 — replacing an interior node would
    orphan its subtree), and is not a parent of any candidate in THIS batch
    (pids reference the pre-round tree; a victim that is also a parent would
    corrupt the batch's own edges).
    """
    B = pids.shape[0]
    N = tree.state.shape[0]          # physical rows (capacity + slack)
    f32, i32 = jnp.float32, jnp.int32
    pids = pids.astype(i32)

    # --- candidate scores, best-first order ---
    t_new = tree.node_time[pids] + length.astype(f32) * dt
    c_score = jnp.where(in_goal, t_new - _GOAL_OFFSET, gcost)
    c_score = jnp.where(length >= 1, c_score, jnp.inf)
    c_order = jnp.argsort(c_score)
    c_score_s = c_score[c_order]
    pids_s = pids[c_order]
    length_s = length[c_order]
    in_goal_s = in_goal[c_order]
    t_new_s = t_new[c_order]

    # --- replaceable leaves, worst-first ---
    idx = jnp.arange(N)
    live = (idx >= 1) & (idx < jnp.minimum(tree.size, limit))
    parent_used = jnp.zeros(N, bool).at[pids].set(True, mode="drop")
    replaceable = (live & (tree.n_children == 0) & (~tree.in_goal)
                   & (~parent_used))
    v_score = jnp.where(replaceable, tree.goal_cost, -jnp.inf)
    v_worst, v_idx = jax.lax.top_k(v_score, B)       # distinct rows

    # --- pair & replace where strictly better ---
    replace = (c_score_s < v_worst) & jnp.isfinite(v_worst)
    slot = jnp.where(replace, v_idx, N).astype(i32)  # N => dropped
    drop = dict(mode="drop")

    old_parent = jnp.where(replace, tree.parent[v_idx], N)
    new_parent = jnp.where(replace, pids_s, N)
    n_children = (tree.n_children
                  .at[old_parent].add(-1, **drop)
                  .at[new_parent].add(1, **drop))

    return tree._replace(
        state=tree.state.at[slot].set(xnew[c_order], **drop),
        S=tree.S.at[slot].set(S_new[c_order], **drop),
        K=tree.K.at[slot].set(K_new[c_order], **drop),
        parent=tree.parent.at[slot].set(pids_s, **drop),
        edge_x=tree.edge_x.at[:, :, slot].set(x_seq[:, :, c_order], **drop),
        edge_u=tree.edge_u.at[:, :, slot].set(u_seq[:, :, c_order], **drop),
        edge_len=tree.edge_len.at[slot].set(length_s, **drop),
        node_time=tree.node_time.at[slot].set(t_new_s, **drop),
        in_goal=tree.in_goal.at[slot].set(in_goal_s, **drop),
        goal_cost=tree.goal_cost.at[slot].set(gcost[c_order], **drop),
        n_children=n_children,
        goal_found=tree.goal_found | jnp.any(in_goal_s & replace),
    )

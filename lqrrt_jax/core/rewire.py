"""Batched tree rewiring: the mechanism that makes the anytime budget buy
plan quality (SURVEY.md C2/C7 "anytime refinement").

The reference keeps growing until budget expiry and keeps the best-so-far
branch; once this framework's fixed-capacity tree saturates, leaf replacement
(core/commit.py commit_batch_refine) improves the tree's score *multiset* but
cannot shorten an already-committed goal path, because committed ancestors'
root->node times are immutable.  Rewiring fixes that: an RRT*-style
choose-parent pass, batched on the device.

One rewire round:

1. Pick a batch of distinct, live, non-root TARGET nodes (a random-offset
   window over the node index range — full coverage every ~capacity/batch
   rounds).
2. For each target, pick the best candidate SOURCE: the LQR-metric nearest
   node among *time-predecessors* (node_time[src] + dt < node_time[tgt]),
   excluding the target's current parent (re-steering the incumbent edge buys
   nothing).  The time mask also excludes the target itself and all of its
   descendants (a descendant's root time is strictly larger), so re-parenting
   can never create a cycle.
3. Steer source -> target state (the same lax.scan rollout as growth); the
   rewire is accepted iff the rollout converges to the target state within
   ``error_tol`` (the same continuity contract the reference's pruning pass
   uses) AND strictly shortens the target's root arrival time.
4. Apply accepted rewires as masked scatters (parent/edge/child-count), then
   recompute every node's root->node time with a pointer-doubling pass —
   O(log N) gathers, so descendants of every rewired node see the shorter
   arrival time immediately.

Acyclicity of batched application: judged against one pre-round node_time
snapshot, every surviving edge (old or new) strictly increases snapshot time
along parent->child, so the union is a DAG with a strictly monotone potential
— no cycle regardless of how many rewires land in one batch.  Times only
decrease, so the per-row improvement estimates are conservative.
"""
from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp

from .steer import make_steer
from .tree import TreeArrays

_EPS_IMPROVE = 1e-4   # required strict arrival-time gain (s)


def recompute_node_times(parent, edge_len, dt: float) -> jnp.ndarray:
    """Root->node trajectory time for every row, by pointer doubling.

    parent: (N,) int32, -1 for root/unused rows; edge_len: (N,) int32.
    After k iterations each row has accumulated its 2^k nearest ancestors'
    edge durations and points at its 2^k-th ancestor; ceil(log2(N)) + 1
    iterations suffice for any tree shape.  Cost: O(N log N) gathers —
    microseconds next to one steer batch.
    """
    N = parent.shape[0]
    sent = jnp.asarray(N, jnp.int32)          # virtual root: d=0, p=self
    d = jnp.where(parent >= 0, edge_len.astype(jnp.float32) * dt, 0.0)
    p = jnp.where(parent >= 0, parent, sent)
    d = jnp.concatenate([d, jnp.zeros((1,), jnp.float32)])
    p = jnp.concatenate([p, sent[None]])
    iters = max(int(math.ceil(math.log2(max(N, 2)))) + 1, 1)

    def body(_, carry):
        d, p = carry
        return d + d[p], p[p]

    d, _ = jax.lax.fori_loop(0, iters, body, (d, p))
    return d[:N]


def make_nearest_pred(erf: Callable, block: int = 1024) -> Callable:
    """Blocked LQR-metric nearest neighbor restricted to time-predecessors.

    nearest(states, S, node_time, live, x_t, time_t, excl, dt)
      -> (src_ids, costs)

    Same blocked running-argmin structure as core.nearest.make_nearest, with
    three extra per-node masks: row < live, node_time + dt < time_t (strict
    time-predecessor — excludes the target and its whole subtree), and
    row != excl (the target's current parent).
    """
    erf_b = jax.vmap(erf, in_axes=(None, 0))
    erf_bb = jax.vmap(erf_b, in_axes=(0, None))

    def nearest(states, S, node_time, live, x_t, time_t, excl, dt):
        N, n = states.shape
        B = x_t.shape[0]
        blk = min(block, N)
        nblocks = max(N // blk, 1)

        def body(carry, i):
            best_cost, best_id = carry
            s = jax.lax.dynamic_slice(states, (i * blk, 0), (blk, n))
            Sb = jax.lax.dynamic_slice(S, (i * blk, 0, 0), (blk, n, n))
            tb = jax.lax.dynamic_slice(node_time, (i * blk,), (blk,))
            e = erf_bb(x_t, s)                       # (B, blk, n)
            q = jnp.einsum("ijk,bik->bij", Sb, e,
                           precision=jax.lax.Precision.HIGHEST)
            cost = jnp.sum(e * q, axis=-1)           # (B, blk)
            idx = i * blk + jnp.arange(blk)
            ok = ((idx[None, :] < live)
                  & (tb[None, :] + dt < time_t[:, None])
                  & (idx[None, :] != excl[:, None]))
            cost = jnp.where(ok, cost, jnp.inf)
            bc = jnp.min(cost, axis=1)
            bi = idx[jnp.argmin(cost, axis=1)]
            take = bc < best_cost
            return (jnp.where(take, bc, best_cost),
                    jnp.where(take, bi, best_id)), None

        init = (jnp.full((B,), jnp.inf), jnp.zeros((B,), jnp.int32))
        (cost, ids), _ = jax.lax.scan(body, init, jnp.arange(nblocks))
        return ids, cost

    return nearest


def make_rewire(spec, dynamics: Callable, lqr: Callable, erf: Callable,
                is_feasible: Callable, error_tol, batch: int,
                wrap_mask=None, saturate: Callable | None = None) -> Callable:
    """Build rewire(tree, key) -> tree (see module docstring).

    ``spec``: core.rounds.RoundSpec (capacity/horizon/dt/nn_block).
    ``batch``: rewire targets per call.  ``lqr`` is unused (node S/K are kept
    — the node state does not change) but accepted for signature symmetry.
    """
    del lqr
    dt = spec.dt
    steer = make_steer(dynamics, erf, is_feasible, spec.horizon_steps, dt,
                       error_tol, saturate=saturate, layout="tm")
    nearest = make_nearest_pred(erf, block=min(spec.nn_block, spec.capacity))

    def rewire(tree: TreeArrays, key) -> TreeArrays:
        N = tree.state.shape[0]                  # physical rows (cap + slack)
        i32, f32 = jnp.int32, jnp.float32
        live = jnp.minimum(tree.size, jnp.asarray(spec.capacity, i32))
        nlive = jnp.maximum(live - 1, 1)         # non-root live rows

        # --- distinct targets: random-offset contiguous window over [1, live)
        start = jax.random.randint(key, (), 0, nlive, dtype=i32)
        t_idx = 1 + (start + jnp.arange(batch, dtype=i32)) % nlive
        valid_t = jnp.arange(batch) < (live - 1)

        x_t = tree.state[t_idx]
        time_t = tree.node_time[t_idx]
        cur_parent = tree.parent[t_idx]

        # --- best candidate source per target (masked LQR-metric NN) ---
        src, _ = nearest(tree.state, tree.S, tree.node_time, live, x_t,
                         time_t, cur_parent, dt)

        # --- steer source -> target state; accept on convergence + gain ---
        res = steer(tree.state[src], tree.K[src], x_t)
        t_new = tree.node_time[src] + res.length.astype(f32) * dt
        improve = (res.reached & valid_t & (res.length >= 1)
                   & (t_new < time_t - _EPS_IMPROVE))

        x_seq = res.x_seq                            # (H, n, B) time-major
        if wrap_mask is not None:
            from ..ops.angles import wrap_angle
            x_seq = jnp.where(jnp.asarray(wrap_mask)[None, :, None],
                              wrap_angle(x_seq), x_seq)

        slot = jnp.where(improve, t_idx, N).astype(i32)  # N => dropped
        drop = dict(mode="drop")
        old_p = jnp.where(improve, cur_parent, N)
        new_p = jnp.where(improve, src, N)
        n_children = (tree.n_children
                      .at[old_p].add(-1, **drop)
                      .at[new_p].add(1, **drop))
        tree = tree._replace(
            parent=tree.parent.at[slot].set(src.astype(i32), **drop),
            edge_x=tree.edge_x.at[:, :, slot].set(x_seq, **drop),
            edge_u=tree.edge_u.at[:, :, slot].set(res.u_seq, **drop),
            edge_len=tree.edge_len.at[slot].set(res.length, **drop),
            n_children=n_children)

        # --- propagate shorter arrival times to every descendant ---
        node_time = recompute_node_times(tree.parent, tree.edge_len, dt)
        return tree._replace(node_time=node_time)

    return rewire

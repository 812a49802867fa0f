"""LQR-metric nearest-neighbor search over the SoA tree.

Reference: Planner._nearest picks the tree node minimizing the LQR
cost-to-go quadratic form e' S e with e = erf(x_node, xrand), vectorized over
the node array — the reference's only data-parallel code (SURVEY.md C4).

The scan is blocked over node tiles inside a lax.scan with a running
(min, argmin) merge, so peak memory stays O(batch x block x n) regardless of
tree capacity, and each block is a dense batched contraction.  This is the
plain reference; the fused Pallas kernel (lqrrt_jax/ops/pallas/nn_kernel.py)
replaces it on a GPU for affine erfs (BASELINE.json: "NN search -> Pallas
blocked argmin").
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

# float32 contractions (no TF32): the costs decide the argmin
_HI = jax.lax.Precision.HIGHEST


def make_nearest(erf: Callable, block: int = 1024) -> Callable:
    """Build nearest(states, S, size, xrand) -> (ids, costs).

    states: (N, n); S: (N, n, n); size: scalar int; xrand: (B, n).
    Returns per-candidate nearest node id (B,) and its metric cost (B,).
    N must be a multiple of ``block`` (tree capacities are powers of two).
    """
    # erf over one sample vs a block of nodes: (n,), (block, n) -> (block, n)
    erf_b = jax.vmap(erf, in_axes=(None, 0))
    # ... and over the candidate batch: (B, n), (block, n) -> (B, block, n)
    erf_bb = jax.vmap(erf_b, in_axes=(0, None))

    def nearest(states, S, size, xrand):
        N, n = states.shape
        B = xrand.shape[0]
        nblocks = max(N // block, 1)
        blk = min(block, N)

        def body(carry, i):
            best_cost, best_id = carry
            s = jax.lax.dynamic_slice(states, (i * blk, 0), (blk, n))
            Sb = jax.lax.dynamic_slice(S, (i * blk, 0, 0), (blk, n, n))
            e = erf_bb(xrand, s)                       # (B, blk, n)
            q = jnp.einsum("ijk,bik->bij", Sb, e,
                           precision=_HI)              # (B, blk, n)
            cost = jnp.sum(e * q, axis=-1)             # (B, blk)
            idx = i * blk + jnp.arange(blk)
            cost = jnp.where(idx[None, :] < size, cost, jnp.inf)
            bc = jnp.min(cost, axis=1)
            bi = idx[jnp.argmin(cost, axis=1)]
            take = bc < best_cost
            return (jnp.where(take, bc, best_cost),
                    jnp.where(take, bi, best_id)), None

        init = (jnp.full((B,), jnp.inf), jnp.zeros((B,), jnp.int32))
        (cost, ids), _ = jax.lax.scan(body, init, jnp.arange(nblocks))
        return ids, cost

    return nearest


def goal_cost_to_go(erf: Callable, states, S, goal):
    """Per-node heuristic e' S e toward the goal (best-node selection,
    SURVEY.md C7: 'argmin of S-weighted cost-to-go toward goal')."""
    e = jax.vmap(erf, in_axes=(None, 0))(goal, states)     # (N, n)
    return jnp.einsum("ij,ijk,ik->i", e, S, e, precision=_HI)

"""The jitted expansion round: sample -> nearest -> steer -> commit.

This is the batched replacement for the reference's per-iteration grow loop
(Planner.update_plan hot loop, SURVEY.md C2 / section 3.2).  One round expands
a whole batch of candidates end-to-end on device; the host runs rounds until
the wall-clock budget expires, preserving the reference's anytime semantics at
round granularity (SURVEY.md section 3.4: no mid-kernel preemption).

Design notes (SURVEY.md section 7 hard parts):
* Batch commit: every candidate with a non-empty feasible rollout becomes a
  node, exactly like the sequential reference ("if rollout nonempty:
  tree.add_node"); multiple children of one parent are fine, so no conflict
  resolution is needed — only a compacting masked scatter (core/commit.py).
* Candidates in the same round cannot select each other as parents (they all
  see the tree as of the round start).  This is the standard batched-RRT
  relaxation of sequential insert ordering; golden tests compare trajectories
  within tolerance, not node-for-node (SURVEY.md section 7).

The per-candidate compute is split out as ``make_expand`` so the multi-device
sharded round (parallel/sharded.py) can run it on a per-device batch shard and
commit the all-gathered results through the identical commit path.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .commit import (commit_batch, commit_batch_dense,
                     commit_batch_dense_all, commit_batch_refine)
from .nearest import make_nearest
from .sampling import sample_batch
from .steer import make_steer
from .tree import TreeArrays


class RoundSpec(NamedTuple):
    """Static (trace-time) configuration of an expansion round."""
    nstates: int
    ncontrols: int
    batch: int              # candidates per round
    horizon_steps: int      # steer rollout cap H
    capacity: int           # logical tree capacity N
    dt: float
    nn_block: int = 1024
    slack: int = 0          # spare rows past N (init_tree(slack=...)); when
                            # >= batch the scatter-free dense commit is used
    commit_all: bool = False  # sort/gather-free dense commit: every
                              # candidate row lands (empty rollouts as
                              # zero-length duplicates of their parent) —
                              # see commit_batch_dense_all


class Candidates(NamedTuple):
    """Per-candidate expansion results, ready for commit.

    Scalar-per-candidate fields are batch-leading (B, ...); the edge rollout
    buffers are TIME-MAJOR — x_seq (H, n, B), u_seq (H, m, B) — matching
    both the steer scan's natural output stacking and the tree's edge
    storage (core/tree.py), so commit is relayout-free."""
    pids: jnp.ndarray
    length: jnp.ndarray
    x_seq: jnp.ndarray      # (H, n, B)
    u_seq: jnp.ndarray      # (H, m, B)
    xnew: jnp.ndarray
    S_new: jnp.ndarray
    K_new: jnp.ndarray
    in_goal: jnp.ndarray
    gcost: jnp.ndarray


def make_expand(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                erf: Callable, is_feasible: Callable, error_tol,
                goal_buffer, wrap_mask=None,
                saturate: Callable | None = None,
                nearest_fn: Callable | None = None,
                steer_fn: Callable | None = None) -> Callable:
    """Build expand(tree, xrand, goal) -> Candidates.

    nearest (C4) -> steer (C5) -> endpoint LQR (batched Riccati) -> goal test
    (C6) for an arbitrary-size candidate batch (the batch dimension is taken
    from ``xrand``, so the same expand serves full and per-shard batches).

    ``nearest_fn`` optionally replaces the jnp blocked NN scan (e.g. with the
    fused Pallas kernel, ops/pallas/nn_kernel.py); same signature as
    core.nearest.make_nearest's product.

    ``steer_fn`` optionally replaces the lax.scan rollout with a custom
    implementation; must honor the layout="tm" SteerResult contract.
    """
    nearest = nearest_fn if nearest_fn is not None else make_nearest(
        erf, block=min(spec.nn_block, spec.capacity))
    # First-entry goal truncation (C6 refinement) is FUSED into the steer
    # scan (core/steer.py goal_buffer=): the reference tests only the rollout
    # ENDPOINT, so goal-reaching edges keep the full horizon and plan
    # durations quantize at horizon multiples (a 5 s boat horizon makes every
    # goal plan a multiple of ~5 s, hiding anytime refinement).  Cutting the
    # edge at its FIRST in-goal step strictly dominates: the prefix was
    # already feasibility-checked by the steer, the node still satisfies the
    # goal box, and time-to-goal gains dt resolution so refinement rounds
    # measurably shorten plans.  Fusing it into the scan carry (vs a second
    # (B, H, n) erf sweep over the materialized rollout) recovers the ~20%
    # round throughput the sweep cost in round 2.
    steer = steer_fn if steer_fn is not None else make_steer(
        dynamics, erf, is_feasible, spec.horizon_steps,
        spec.dt, error_tol, saturate=saturate,
        goal_buffer=goal_buffer, layout="tm")
    lqr_batch = jax.vmap(lqr)
    erf_goal = jax.vmap(erf, in_axes=(None, 0))

    def expand(tree: TreeArrays, xrand, goal) -> Candidates:
        # --- nearest neighbor under the LQR metric (C4) ---
        pids, _ = nearest(tree.state, tree.S, tree.size, xrand)
        x0 = tree.state[pids]
        K0 = tree.K[pids]

        # --- steer rollouts with first-entry goal stop (C5 + C6);
        # layout="tm": x_seq/u_seq come out time-major (H, ·, B), exactly
        # the commit layout — no relayout anywhere in the round ---
        res = steer(x0, K0, xrand, goal)
        length = res.length
        xnew = res.xnew
        in_goal = res.in_goal

        # --- per-candidate LQR at the new endpoint (batched Riccati) ---
        u_last = jnp.take_along_axis(
            res.u_seq, jnp.broadcast_to(
                jnp.maximum(length - 1, 0)[None, None, :],
                (1,) + res.u_seq.shape[1:]), axis=0)[0].T   # (B, m)
        S_new, K_new = lqr_batch(xnew, u_last)

        x_seq = res.x_seq
        if wrap_mask is not None:
            # Wrap angle dims in BOTH the endpoint and the stored edge states,
            # so mid-edge states handed back by get_state(t) honor the erf
            # contract too (round 1 wrapped only xnew); the planner's
            # interpolator is wrap-aware across the +-pi seam.
            from ..ops.angles import wrap_angle
            xnew = jnp.where(wrap_mask, wrap_angle(xnew), xnew)
            x_seq = jnp.where(jnp.asarray(wrap_mask)[None, :, None],
                              wrap_angle(x_seq), x_seq)

        # --- cost-to-go heuristic (C7 fallback metric) ---
        e_goal = erf_goal(goal, xnew)
        gcost = jnp.einsum("bi,bij,bj->b", e_goal, S_new, e_goal,
                           precision=jax.lax.Precision.HIGHEST)

        return Candidates(pids=pids, length=length, x_seq=x_seq,
                          u_seq=res.u_seq, xnew=xnew, S_new=S_new,
                          K_new=K_new, in_goal=in_goal, gcost=gcost)

    return expand


def commit_candidates(spec: RoundSpec, tree: TreeArrays, c: Candidates,
                      mode: str = "grow") -> TreeArrays:
    """Shared commit-path selection for single-chip and sharded rounds.

    mode="grow": append every feasible candidate (dense slice when the tree
    carries >= batch slack rows, masked scatter otherwise).  mode="refine":
    leaf replacement for a full tree (commit_batch_refine).
    """
    if mode == "refine":
        return commit_batch_refine(
            tree, spec.dt, spec.capacity, c.pids, c.length, c.x_seq, c.u_seq,
            c.xnew, c.S_new, c.K_new, c.in_goal, c.gcost)
    if spec.slack >= c.pids.shape[0]:  # scatter-free dense commit
        if spec.commit_all:
            return commit_batch_dense_all(
                tree, spec.dt, spec.capacity, c.pids, c.length, c.x_seq,
                c.u_seq, c.xnew, c.S_new, c.K_new, c.in_goal, c.gcost)
        return commit_batch_dense(
            tree, spec.dt, spec.capacity, c.pids, c.length, c.x_seq,
            c.u_seq, c.xnew, c.S_new, c.K_new, c.in_goal, c.gcost)
    return commit_batch(tree, spec.dt, c.pids, c.length, c.x_seq, c.u_seq,
                        c.xnew, c.S_new, c.K_new, c.in_goal, c.gcost)


def make_round(spec: RoundSpec, dynamics: Callable, lqr: Callable,
               erf: Callable, is_feasible: Callable, error_tol,
               goal_buffer, wrap_mask=None,
               xrand_gen: Callable | None = None,
               saturate: Callable | None = None,
               nearest_fn: Callable | None = None,
               steer_fn: Callable | None = None,
               commit: str = "grow") -> Callable:
    """Build the jittable single-chip round function.

    round(tree, key, goal, sample_space, goal_bias, bias_target) -> TreeArrays

    All callbacks are trace-time constants; changing them (e.g. swapping the
    feasibility function, SURVEY.md C9) requires rebuilding the round.
    ``wrap_mask``: optional (n,) bool marking angle dims to wrap when storing
    node states (keeps the NN metric exact for angle dims).
    ``commit``: "grow" (append) or "refine" (leaf replacement for a full
    tree — the anytime budget keeps buying plan quality past capacity).
    """
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, steer_fn=steer_fn)

    def round_fn(tree: TreeArrays, key, goal, sample_space, goal_bias,
                 bias_target) -> TreeArrays:
        # --- sample (C3) ---
        if xrand_gen is None:
            xrand = sample_batch(key, spec.batch, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(key, spec.batch)

        c = expand(tree, xrand, goal)

        # --- masked compacting commit (C8 insert) ---
        return commit_candidates(spec, tree, c, mode=commit)

    return round_fn


def make_refine_round(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                      erf: Callable, is_feasible: Callable, error_tol,
                      goal_buffer, wrap_mask=None,
                      xrand_gen: Callable | None = None,
                      saturate: Callable | None = None,
                      nearest_fn: Callable | None = None,
                      steer_fn: Callable | None = None) -> Callable:
    """The capacity-saturated anytime round: leaf replacement + rewiring.

    Once the tree is full, plain leaf replacement (commit_batch_refine)
    improves the node-score multiset but cannot shorten a committed goal
    path.  This round splits the batch: half the
    candidates expand-and-replace as before, and half drive an RRT*-style
    rewire pass (core/rewire.py) that re-parents existing nodes onto
    shorter arriving edges and propagates the gain to all descendants — so
    additional budget measurably shortens the committed plan.

    Same signature/cost envelope as the grow round: B/2 NN+steer for
    expansion plus B/2 NN+steer for rewiring per call.
    """
    from .rewire import make_rewire

    half = max(spec.batch // 2, 1)
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, steer_fn=steer_fn)
    rewire = make_rewire(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         batch=max(spec.batch - half, 1),
                         wrap_mask=wrap_mask, saturate=saturate)

    def round_fn(tree: TreeArrays, key, goal, sample_space, goal_bias,
                 bias_target) -> TreeArrays:
        k_sample, k_rewire = jax.random.split(key)
        if xrand_gen is None:
            xrand = sample_batch(k_sample, half, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(k_sample, half)
        c = expand(tree, xrand, goal)
        tree = commit_candidates(spec, tree, c, mode="refine")
        return rewire(tree, k_rewire)

    return round_fn


def jit_round(round_fn: Callable) -> Callable:
    """Jit with tree-buffer donation: the round updates the tree in place on
    device, avoiding a full copy of the (possibly >100 MB) SoA arrays."""
    return jax.jit(round_fn, donate_argnums=(0,))

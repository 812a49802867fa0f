"""Multi-device expansion rounds via shard_map (P1/P2 of SURVEY.md 2.4).

Strategy (BASELINE.json north star: "shard sample batches ... per host,
reducing best-candidate edges via collectives"):

* The tree is REPLICATED on every device (it is the read-hot structure: every
  candidate's NN scan reads all of it; replication turns the scan into pure
  local compute with zero communication).
* The candidate batch is SHARDED over the "dp" mesh axis: each device draws
  its own fold of the round key, runs nearest+steer+Riccati on batch/n_dev
  candidates (the expensive part), then candidates are exchanged and
  every device commits the identical set — so the replicated trees stay
  bit-identical round after round.

Two best-edge collectives (P2), selectable per round:

* ``collective="gather"`` — all_gather the FULL candidate batch (rollout
  buffers included) and commit everything feasible, exactly matching the
  single-chip round's semantics.  Comm volume per round per device ~
  batch x H x (n+m) floats.
* ``collective="topk"`` — the reduced best-edge exchange: all_gather only a
  per-candidate score (B floats), compute the identical global top-k on
  every device, then psum k zero-masked winner rows so each device ends up
  with the full data of exactly the k globally-best candidates.  Comm volume
  ~ (B + 2k x H x (n+m)) floats vs B x H x (n+m): a batch/(2k) reduction
  for the dominant rollout buffers.  Semantics: at most k commits per round
  (best-first), a *selective* policy rather than commit-everything.

Scores rank goal-reaching candidates first (shorter root->node time wins),
then ascending LQR cost-to-go — the same criterion best_node uses.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.rounds import (Candidates, RoundSpec, commit_candidates,
                           make_expand)
from ..core.sampling import sample_batch
from ..core.tree import TreeArrays

try:  # jax >= 0.8 moved shard_map to the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

_GOAL_SCORE_OFFSET = 1e9   # goal candidates rank below any cost-to-go score

# Candidates fields whose candidate axis is the LAST one (time-major rollout
# buffers, core/rounds.py Candidates); every other field is batch-leading.
_TM_FIELDS = frozenset({"x_seq", "u_seq"})


def gather_candidates(c: Candidates, axis) -> Candidates:
    """all_gather a Candidates pytree over mesh ``axis``: batch-leading
    fields tile on axis 0, the time-major rollout buffers on their trailing
    candidate axis."""
    def g(x, last):
        return jax.lax.all_gather(x, axis, axis=(x.ndim - 1) if last else 0,
                                  tiled=True)
    return Candidates(**{f: g(getattr(c, f), f in _TM_FIELDS)
                         for f in Candidates._fields})


def mesh_axis_size(mesh: Mesh, axis) -> int:
    """Total device count over ``axis`` (one name or a tuple of names — the
    2-D (hosts x devices) mesh of parallel.mesh.make_mesh_2d shards
    candidates over BOTH axes; XLA collectives take the tuple directly)."""
    if isinstance(axis, str):
        return mesh.shape[axis]
    out = 1
    for a in axis:
        out *= mesh.shape[a]
    return out


def candidate_scores(tree: TreeArrays, c: Candidates, dt: float):
    """Commit priority, lower = better: infeasible -> +inf; goal-reaching ->
    (root->node time - OFFSET), i.e. always ahead of non-goal; otherwise the
    LQR cost-to-go toward the goal."""
    t_new = tree.node_time[c.pids] + c.length.astype(jnp.float32) * dt
    score = jnp.where(c.in_goal, t_new - _GOAL_SCORE_OFFSET, c.gcost)
    return jnp.where(c.length >= 1, score, jnp.inf)


def make_sharded_round_body(
        spec: RoundSpec, n_dev: int, dynamics: Callable, lqr: Callable,
        erf: Callable, is_feasible: Callable, error_tol, goal_buffer,
        wrap_mask=None, saturate: Callable | None = None,
        nearest_fn: Callable | None = None,
        steer_fn: Callable | None = None,
        xrand_gen: Callable | None = None, axis: str = "dp",
        collective: str = "gather", topk: int | None = None,
        commit: str = "grow") -> Callable:
    """Build the PER-DEVICE round body — call it inside shard_map over
    ``axis`` (e.g. from a jitted chunk loop; parallel.sharded.
    make_sharded_round wraps it for single-round use).

    round_body(tree, key, goal, sample_space, goal_bias, bias_target) -> tree

    The tree argument and result are the per-device (replicated) copies.
    ``xrand_gen(key, local_batch)``, if given, replaces the default sampler;
    it receives a per-device folded key.  spec.batch is the GLOBAL batch.
    ``axis`` is one mesh axis name or a tuple of names (2-D hosts x chips
    mesh): axis_index and the collectives take the tuple directly.
    ``commit``: "grow" or "refine" (leaf replacement once the tree is full;
    core/commit.py commit_batch_refine) — replicated and deterministic, so
    the per-device trees stay bit-identical in either mode.
    """
    if spec.batch % n_dev != 0:
        raise ValueError(f"batch {spec.batch} not divisible by mesh axis "
                         f"{axis}={n_dev}")
    if collective not in ("gather", "topk"):
        raise ValueError(f"unknown collective {collective!r}")
    local_b = spec.batch // n_dev
    rewire = None
    if commit == "refine":
        # Mirror the single-chip refine round (core/rounds.py
        # make_refine_round): half the batch expands-and-replaces, half
        # drives the rewire pass.  The rewire runs REPLICATED — every device
        # derives the same targets/sources from the unfolded round key, so
        # the per-device trees stay bit-identical with zero extra collectives
        # (the candidate half still shards over the mesh as usual).
        from ..core.rewire import make_rewire
        local_b = max(local_b // 2, 1)
        rewire = make_rewire(spec, dynamics, lqr, erf, is_feasible,
                             error_tol, batch=max(spec.batch // 2, 1),
                             wrap_mask=wrap_mask, saturate=saturate)
    if collective == "topk":
        topk = min(int(topk if topk is not None else spec.batch // 8),
                   spec.batch)
        if topk < 1:
            raise ValueError("topk must be >= 1")
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, steer_fn=steer_fn)

    def round_body(tree: TreeArrays, key, goal, sample_space, goal_bias,
                   bias_target) -> TreeArrays:
        if rewire is not None:
            key, key_rw = jax.random.split(key)
        # per-device key fold -> independent sample shard (P1)
        idx = jax.lax.axis_index(axis)
        key_i = jax.random.fold_in(key, idx)
        if xrand_gen is None:
            xrand = sample_batch(key_i, local_b, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(key_i, local_b)

        cand = expand(tree, xrand, goal)         # local compute, no comms

        if collective == "gather":
            # best-edge exchange (P2): all-gather the full candidate batch
            cand_full = gather_candidates(cand, axis)
            tree = commit_candidates(spec, tree, cand_full, mode=commit)
            return tree if rewire is None else rewire(tree, key_rw)

        # --- topk: score exchange + psum of zero-masked winner rows ---
        score = candidate_scores(tree, cand, spec.dt)          # (local_b,)
        score_all = jax.lax.all_gather(score, axis, axis=0, tiled=True)
        _, gidx = jax.lax.top_k(-score_all, topk)              # global ids
        owner = gidx // local_b
        lidx = jnp.where(owner == idx, gidx % local_b, 0)
        mine = owner == idx

        def winner_rows(a, cand_axis_last=False):
            if cand_axis_last:
                rows = a[..., lidx]
                mask = mine.reshape((1,) * (a.ndim - 1) + (topk,))
            else:
                rows = a[lidx]
                mask = mine.reshape((topk,) + (1,) * (a.ndim - 1))
            zero = jnp.zeros_like(rows)
            if a.dtype == jnp.bool_:
                rows = jnp.where(mask, rows, zero).astype(jnp.int32)
                return jax.lax.psum(rows, axis).astype(jnp.bool_)
            return jax.lax.psum(jnp.where(mask, rows, zero), axis)

        winners = Candidates(**{
            f: winner_rows(getattr(cand, f), cand_axis_last=(f in _TM_FIELDS))
            for f in Candidates._fields})
        # rows whose global score was inf (nothing feasible) carry length
        # from an arbitrary owner row: mask them out explicitly
        feas = jnp.take(score_all, gidx) < jnp.inf
        winners = winners._replace(
            length=jnp.where(feas, winners.length, 0))
        tree = commit_candidates(spec, tree, winners, mode=commit)
        return tree if rewire is None else rewire(tree, key_rw)

    return round_body


def make_sharded_round(spec: RoundSpec, mesh: Mesh, dynamics: Callable,
                       lqr: Callable, erf: Callable, is_feasible: Callable,
                       error_tol, goal_buffer, wrap_mask=None,
                       saturate: Callable | None = None,
                       nearest_fn: Callable | None = None,
                       steer_fn: Callable | None = None,
                       xrand_gen: Callable | None = None,
                       axis: str = "dp", collective: str = "gather",
                       topk: int | None = None,
                       commit: str = "grow") -> Callable:
    """Build the multi-device round: same signature and semantics as the
    single-chip round, tree replicated, candidate batch sharded over ``axis``.

    spec.batch is the GLOBAL batch; it must divide by the mesh axis size.
    ``nearest_fn`` (e.g. the Pallas NN kernel) runs per device on the local
    candidate shard against the replicated tree.
    """
    body = make_sharded_round_body(
        spec, mesh_axis_size(mesh, axis), dynamics, lqr, erf, is_feasible,
        error_tol, goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
        nearest_fn=nearest_fn, steer_fn=steer_fn, xrand_gen=xrand_gen,
        axis=axis, collective=collective, topk=topk, commit=commit)
    rep = P()
    # a single P() acts as a prefix spec for each whole argument pytree
    return shard_map(body, mesh=mesh,
                     in_specs=(rep, rep, rep, rep, rep, rep),
                     out_specs=rep, check_vma=False)


def jit_sharded_round(round_fn: Callable, mesh: Mesh) -> Callable:
    return jax.jit(round_fn, donate_argnums=(0,))


def replicate_tree(tree: TreeArrays, mesh: Mesh) -> TreeArrays:
    """Place every tree leaf replicated across the mesh.

    On a multi-process mesh (jax.distributed, P5) device_put cannot target
    non-addressable devices; build the global replicated array from each
    process's identical local copy instead (the callers guarantee the value
    is process-identical: seeds are deterministic functions of replicated
    inputs)."""
    import numpy as np
    sharding = NamedSharding(mesh, P())
    local = set(jax.local_devices())
    if all(d in local for d in mesh.devices.flat):
        return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
    return jax.tree.map(
        lambda x: jax.make_array_from_callback(
            np.shape(x), sharding,
            lambda idx, _x=x: np.asarray(_x)[idx]), tree)

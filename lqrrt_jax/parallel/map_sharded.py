"""P3: obstacle/occupancy-map sharding with collective feasibility reduction
(SURVEY.md section 2.4: "occupancy grids split per host, collision verdicts
reduced"; BASELINE north star: "shard ... obstacle maps per host").

When the world map is too large for one device's HBM (harbor-scale occupancy
at centimeter resolution), the grid is split ROW-WISE across a "map" mesh
axis.  Every device plans the identical candidate batch; collision verdicts
for whole rollout batches are computed against the local slab and OR-reduced
with one psum per round (BASELINE: "collision-checks whole rollout batches
... in one pass").

Design: steering rolls out with only the cheap local predicates (control
limits etc.); the sharded grid then truncates each rollout at its first
occupied step.  This is exact, not an approximation: a rollout's state
sequence does not depend on feasibility (infeasibility only truncates), so
post-hoc truncation commits the identical edge the reference's in-loop check
would — with ONE collective per round instead of one per rollout step.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.commit import commit_batch, commit_batch_dense
from ..core.rounds import RoundSpec, make_expand
from ..core.sampling import sample_batch
from ..core.tree import TreeArrays

try:  # jax >= 0.8 moved shard_map to the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


class ShardedGrid:
    """Row-sharded occupancy grid: device d of the "map" axis holds rows
    [d*rows_per, (d+1)*rows_per) of the (H, W) grid."""

    def __init__(self, occ, origin, resolution: float, n_shards: int,
                 pos_dims=(0, 1)):
        occ = np.asarray(occ) != 0
        H, W = occ.shape
        rows_per = -(-H // n_shards)
        pad = rows_per * n_shards - H
        if pad:
            occ = np.pad(occ, ((0, pad), (0, 0)), constant_values=True)
        self.occ_sharded = occ.reshape(n_shards, rows_per, W)  # leading=shard
        self.origin = np.asarray(origin, np.float32)
        self.resolution = float(resolution)
        self.H, self.W = H, W
        self.rows_per = rows_per
        self.n_shards = n_shards
        self.pos_dims = np.asarray(list(pos_dims))

    def occupied_host(self, p):
        """Full-grid occupancy verdict on the host (numpy): p (..., 2) ->
        bool (...).  Used by the planner facade to validate pruning/finish
        shortcut rollouts, which steer with only the local predicates (the
        sharded slabs live on device; the full grid is cheap host-side)."""
        p = np.asarray(p)
        cell = np.floor((p - self.origin) / self.resolution).astype(np.int64)
        cx, cy = cell[..., 0], cell[..., 1]
        oob = (cx < 0) | (cx >= self.W) | (cy < 0) | (cy >= self.H)
        occ_full = self.occ_sharded.reshape(-1, self.W)[:self.H]
        occ = occ_full[np.clip(cy, 0, self.H - 1), np.clip(cx, 0, self.W - 1)]
        return occ | oob

    def occupied_local(self, p, slab, shard_idx):
        """Occupied-verdict of positions p (..., 2) against ONE slab
        (rows_per, W); points outside the slab's rows contribute False
        (their verdict comes from the owning shard via the reduction)."""
        cell = jnp.floor((p - self.origin) / self.resolution).astype(jnp.int32)
        cx, cy = cell[..., 0], cell[..., 1]
        row0 = shard_idx * self.rows_per
        ly = cy - row0
        in_slab = (ly >= 0) & (ly < self.rows_per) & (cx >= 0) & (cx < self.W)
        occ = slab[jnp.clip(ly, 0, self.rows_per - 1),
                   jnp.clip(cx, 0, self.W - 1)]
        local = jnp.where(in_slab, occ, False)
        # whole-map OOB is conservative-occupied; identical on every shard,
        # OR'd in AFTER the reduction (see occupied_global)
        oob = ((cx < 0) | (cx >= self.W) | (cy < 0) | (cy >= self.H))
        return local, oob


def make_grid_truncate(spec: RoundSpec, grid: ShardedGrid, lqr: Callable,
                       erf: Callable, goal_buffer, axis: str) -> Callable:
    """Build truncate(tree, c, slab, goal) -> Candidates: the sharded
    collision pass.  Each device scores the rollout batch against its LOCAL
    slab; ONE psum over ``axis`` assembles the global occupied mask, and each
    rollout is truncated at its first occupied step (exact — infeasibility
    only truncates, it never changes the state sequence).  The endpoint LQR,
    goal test, and cost-to-go are recomputed at the truncated endpoint.
    Shared by the map-only round (P3) and the dp x map composed round."""
    lqr_batch = jax.vmap(lqr)
    erf_goal = jax.vmap(erf, in_axes=(None, 0))
    goal_buffer = jnp.asarray(goal_buffer, jnp.float32)
    pos_dims = tuple(int(d) for d in grid.pos_dims)

    def truncate(tree, c, slab, goal):
        # time-major rollouts: x_seq (H, n, B) -> positions (H, B, 2)
        p = jnp.moveaxis(c.x_seq[:, pos_dims, :], 1, -1)
        shard_idx = jax.lax.axis_index(axis)
        local, oob = grid.occupied_local(p, slab[0], shard_idx)
        occupied = (jax.lax.psum(local.astype(jnp.int32), axis) > 0) | oob

        H = spec.horizon_steps
        any_occ = jnp.any(occupied, axis=0)              # (B,)
        first = jnp.where(any_occ, jnp.argmax(occupied, axis=0), H)
        length = jnp.minimum(c.length, first.astype(jnp.int32))
        x0 = tree.state[c.pids]
        last = jnp.maximum(length - 1, 0)

        def at_last(seq):                                # (H, d, B) -> (B, d)
            idx = jnp.broadcast_to(last[None, None, :], (1,) + seq.shape[1:])
            return jnp.take_along_axis(seq, idx, axis=0)[0].T

        xnew = jnp.where((length >= 1)[:, None], at_last(c.x_seq), x0)
        u_last = at_last(c.u_seq)
        S_new, K_new = lqr_batch(xnew, u_last)
        e_goal = erf_goal(goal, xnew)
        in_goal = jnp.all(jnp.abs(e_goal) <= goal_buffer, axis=-1)
        gcost = jnp.einsum("bi,bij,bj->b", e_goal, S_new, e_goal,
                           precision=jax.lax.Precision.HIGHEST)
        return c._replace(length=length, xnew=xnew, S_new=S_new, K_new=K_new,
                          in_goal=in_goal, gcost=gcost)

    return truncate


def make_map_sharded_round(spec: RoundSpec, mesh: Mesh, grid: ShardedGrid,
                           dynamics: Callable, lqr: Callable, erf: Callable,
                           local_feasible: Callable, error_tol, goal_buffer,
                           wrap_mask=None, saturate: Callable | None = None,
                           nearest_fn: Callable | None = None,
                           steer_fn: Callable | None = None,
                           axis: str = "map") -> Callable:
    """Round with the occupancy map sharded over ``axis``: candidates and
    tree replicated, ONE psum of slab verdicts truncates the rollout batch.

    ``local_feasible`` holds everything that is NOT the sharded map (control
    limits, analytic obstacles); pass a constant-True predicate if none.
    """
    n_dev = mesh.shape[axis]
    assert grid.n_shards == n_dev, (grid.n_shards, n_dev)
    expand = make_expand(spec, dynamics, lqr, erf, local_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, steer_fn=steer_fn)
    truncate = make_grid_truncate(spec, grid, lqr, erf, goal_buffer, axis)

    def round_body(tree: TreeArrays, slab, key, goal, sample_space,
                   goal_bias, bias_target) -> TreeArrays:
        # identical candidates on every device (no per-device key fold): the
        # map axis parallelizes the WORLD, not the batch
        xrand = sample_batch(key, spec.batch, sample_space, goal_bias,
                             bias_target)
        c = expand(tree, xrand, goal)
        # ---- sharded collision pass over the whole rollout batch (P3) ----
        c = truncate(tree, c, slab, goal)

        commit = (commit_batch_dense if spec.slack >= spec.batch
                  else lambda t, dt, _lim, *a: commit_batch(t, dt, *a))
        return commit(tree, spec.dt, spec.capacity, c.pids, c.length, c.x_seq,
                      c.u_seq, c.xnew, c.S_new, c.K_new, c.in_goal, c.gcost)

    rep = P()
    return shard_map(
        round_body, mesh=mesh,
        in_specs=(rep, P(axis), rep, rep, rep, rep, rep),
        out_specs=rep,
        check_vma=False)


def make_dp_map_round_body(
        spec: RoundSpec, n_dp: int, n_map: int, grid: ShardedGrid,
        dynamics: Callable, lqr: Callable, erf: Callable,
        local_feasible: Callable, error_tol, goal_buffer, wrap_mask=None,
        saturate: Callable | None = None,
        nearest_fn: Callable | None = None,
        steer_fn: Callable | None = None,
        xrand_gen: Callable | None = None,
        dp_axis: str = "dp", map_axis: str = "map") -> Callable:
    """PER-DEVICE body of the P1 x P3 composed round — call it inside a
    shard_map over a 2-D (dp, map) mesh (e.g. from the Planner facade's
    jitted chunk loop; make_dp_map_round wraps it for single-round use).

    round_body(tree, slab, key, goal, sample_space, goal_bias, bias_target)

    Layout: device (i, j) steers candidate shard i (identical for all j —
    the key folds over dp only) and holds grid slab j.  Per round: the
    collision psum over ``map_axis`` assembles each dp-row's full verdicts,
    then the all-gather over ``dp_axis`` exchanges the surviving candidates;
    the tree commits replicated everywhere.  Comm: one (local_b x H) int
    psum on the map axis + the candidate gather on the dp axis.
    spec.batch is the GLOBAL candidate batch (divided over dp_axis).
    ``xrand_gen(key_i, local_b)``, if given, replaces the default sampler
    and receives the per-dp-row folded key.
    """
    assert grid.n_shards == n_map, (grid.n_shards, n_map)
    if spec.batch % n_dp != 0:
        raise ValueError(f"batch {spec.batch} not divisible by {dp_axis}="
                         f"{n_dp}")
    local_b = spec.batch // n_dp
    expand = make_expand(spec, dynamics, lqr, erf, local_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, steer_fn=steer_fn)
    truncate = make_grid_truncate(spec, grid, lqr, erf, goal_buffer, map_axis)

    def round_body(tree: TreeArrays, slab, key, goal, sample_space,
                   goal_bias, bias_target) -> TreeArrays:
        # P1: per-dp-row key fold; all map shards of a row draw identically
        di = jax.lax.axis_index(dp_axis)
        key_i = jax.random.fold_in(key, di)
        if xrand_gen is None:
            xrand = sample_batch(key_i, local_b, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(key_i, local_b)
        c = expand(tree, xrand, goal)        # local compute
        # P3: map-axis collision reduction on the local candidate shard
        c = truncate(tree, c, slab, goal)
        # P2: candidate exchange over the dp axis, replicated commit
        from .sharded import gather_candidates
        c_full = gather_candidates(c, dp_axis)
        commit = (commit_batch_dense if spec.slack >= spec.batch
                  else lambda t, dt, _lim, *a: commit_batch(t, dt, *a))
        return commit(tree, spec.dt, spec.capacity, c_full.pids,
                      c_full.length, c_full.x_seq, c_full.u_seq, c_full.xnew,
                      c_full.S_new, c_full.K_new, c_full.in_goal,
                      c_full.gcost)

    return round_body


def make_dp_map_round(spec: RoundSpec, mesh: Mesh, grid: ShardedGrid,
                      dynamics: Callable, lqr: Callable, erf: Callable,
                      local_feasible: Callable, error_tol, goal_buffer,
                      wrap_mask=None, saturate: Callable | None = None,
                      nearest_fn: Callable | None = None,
                      dp_axis: str = "dp", map_axis: str = "map") -> Callable:
    """P1 x P3 composed round over a 2-D (dp, map) mesh: the candidate batch
    is sharded over ``dp_axis`` AND the occupancy grid over ``map_axis`` —
    the harbor-scale-map + large-batch case the mutually-exclusive P1/P3
    rounds could not express (round-1 review, missing item 3).

    round(tree, slab, key, goal, sample_space, goal_bias, bias_target).
    Reachable from the Planner facade via Planner(mesh=..,
    feasibility_grid=ShardedGrid(...)) with the full anytime surface.
    """
    body = make_dp_map_round_body(
        spec, mesh.shape[dp_axis], mesh.shape[map_axis], grid, dynamics,
        lqr, erf, local_feasible, error_tol, goal_buffer,
        wrap_mask=wrap_mask, saturate=saturate, nearest_fn=nearest_fn,
        dp_axis=dp_axis, map_axis=map_axis)
    rep = P()
    return shard_map(
        body, mesh=mesh,
        in_specs=(rep, P(map_axis), rep, rep, rep, rep, rep),
        out_specs=rep,
        check_vma=False)

"""Planner facade — API parity with the reference's lqrrt/planner.py.

Reference public surface (SURVEY.md C1-C13, lqrrt/planner.py): __init__,
update_plan, get_state, get_effort, set_goal, kill_update, unkill, visualize,
with constructor params (dynamics, lqr, constraints, horizon, dt=0.05, FPR=0,
error_tol=0.05, erf=subtract, min_time=0.5, max_time=1, max_nodes=1e5,
goal0=None, sys_time=time.time, printing=True).  [Reference mount was empty at
survey time; citations follow SURVEY.md's provenance convention.]

Re-architecture: the sequential grow loop becomes a host loop over jitted
*chunks* of expansion rounds (core/rounds.py) on a fixed-capacity device tree.
One device dispatch runs ``rounds_per_chunk`` full rounds via lax.fori_loop,
and the host reads back a single packed (size, goal_found) stats vector per
chunk — so per-dispatch latency (launch, PCIe, host scheduling) is amortized
over thousands of expansions instead of being paid four times per round.
Anytime/preemption semantics hold at chunk granularity (SURVEY.md sections
3.4, 7).

User callbacks (dynamics, lqr, erf, is_feasible, xrand_gen) must be
jax-traceable; the framework vmaps them across the candidate batch.

Device knobs are keyword-only extras: batch_size (candidates per round),
capacity (tree array size), wrap_dims (angle dims wrapped in node storage),
nn_block (NN scan tile), rounds_per_chunk (rounds fused per dispatch),
nn_impl ("auto" | "pallas" | "jnp" nearest-neighbor backend), refine_mode ("restart" |
"leaf_rewire" capacity-saturated refinement policy), seed (PRNG).

FPR note: the reference's FPR parameter semantics could not be verified
(SURVEY.md section 3.1 [LOW]); here FPR in [0, 1] is implemented as
fraction-of-plan-retention — that fraction of each round's sample batch is
drawn from the previous committed plan's states, warm-starting replans.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .constraints import Constraints
from .core.rounds import RoundSpec, make_refine_round, make_round
from .core.sampling import normalize_goal_bias, sample_batch
from .core.steer import make_steer
from .core.tree import TreeArrays, best_node, init_tree
from .tree import Tree

_FPR_PLAN_LEN = 256   # resampled previous-plan states kept for FPR biasing
_PRUNE_MAX = 32       # chain nodes covered by the all-pairs shortcut batch
_FINISH_BATCH = 8     # tiled batch for the terminal goal connection


def _quad(e, S):
    """e' S e at full float32 (no TF32): it decides goal and best-node
    choices."""
    hi = jax.lax.Precision.HIGHEST
    return jnp.dot(e, jnp.dot(S, e, precision=hi), precision=hi)


def _chunk_stats(tree):
    """Per-chunk stats vector, f32: [size, goal_found, best_goal_time,
    best_goal_cost, best_id, n_live].  Carrying the restart-stash score
    inside the chunk's one pipelined stats fetch means a restart needs ZERO
    extra dispatches or fetches (the score used to be a separate jitted
    program + device round trip per restart).  f32 holds ids/sizes exactly
    up to 2^24 — far above any practical capacity.

    ``n_live`` counts rows with a real incoming edge (plus the root): the
    sort-free commit_all path stores empty-rollout candidates as inert
    zero-length duplicates (core/commit.py commit_batch_dense_all), so
    ``size`` counts committed rows while ``n_live`` is the honest node count
    the stats report."""
    b = best_node(tree)
    f32 = jnp.float32
    live = jnp.sum((tree.edge_len >= 1) & tree.valid_mask(),
                   dtype=jnp.int32) + 1
    return jnp.stack([
        tree.size.astype(f32),
        tree.goal_found.astype(f32),
        jnp.where(tree.goal_found, tree.node_time[b], jnp.inf),
        tree.goal_cost[b],
        b.astype(f32),
        live.astype(f32)])


class Planner:
    def __init__(self, dynamics: Callable, lqr: Callable,
                 constraints: Constraints, horizon: float, dt: float = 0.05,
                 FPR: float = 0.0, error_tol=0.05, erf: Callable = jnp.subtract,
                 min_time: float = 0.5, max_time: float = 1.0,
                 max_nodes: Optional[int] = None, goal0=None,
                 sys_time: Callable = time.time, printing: bool = True, *,
                 batch_size: int = 512, capacity: Optional[int] = None,
                 wrap_dims=(), nn_block: int = 1024, seed: int = 0,
                 saturate: Optional[Callable] = None,
                 rounds_per_chunk: int = 8, nn_impl: str = "auto",
                 steer_impl: str = "scan",
                 mesh=None, mesh_axis: str = "dp",
                 collective: str = "gather", topk: Optional[int] = None,
                 refine: bool = True, refine_mode: str = "restart",
                 informed: float = 0.5,
                 informed_anneal: float = 1.0,
                 feasibility_grid=None, map_axis: str = "map"):
        if horizon <= 0 or dt <= 0:
            raise ValueError("horizon and dt must be positive")
        if nn_impl not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown nn_impl {nn_impl!r}")
        if steer_impl in ("auto",):
            steer_impl = "scan"
        if steer_impl != "scan":
            raise ValueError(
                f"steer_impl {steer_impl!r} is not available: the lax.scan "
                "rollout ('scan') is the only steer implementation")
        if collective not in ("gather", "topk"):
            raise ValueError(f"unknown collective {collective!r}")
        if mesh is not None:
            from .parallel.sharded import mesh_axis_size
            if not isinstance(mesh_axis, str):
                mesh_axis = tuple(mesh_axis)   # hashable for the chunk cache
            n_dev = mesh_axis_size(mesh, mesh_axis)
            if int(batch_size) % n_dev != 0:
                raise ValueError(
                    f"batch_size={batch_size} must divide by the mesh "
                    f"'{mesh_axis}' axis size {n_dev}")
        if feasibility_grid is not None:
            if mesh is None:
                raise ValueError("feasibility_grid requires mesh= (the grid "
                                 "slabs shard over the mesh's map axis)")
            if map_axis not in mesh.shape:
                raise ValueError(f"mesh has no '{map_axis}' axis for the "
                                 f"sharded grid (axes: {tuple(mesh.shape)})")
            if feasibility_grid.n_shards != mesh.shape[map_axis]:
                raise ValueError(
                    f"grid has {feasibility_grid.n_shards} shards but mesh "
                    f"'{map_axis}' axis has {mesh.shape[map_axis]} devices")
        self.dynamics = dynamics
        self.lqr = lqr
        self.constraints = constraints
        self.horizon = float(horizon)
        self.dt = float(dt)
        self.FPR = float(FPR)
        self.error_tol = error_tol
        self.erf = erf
        self.saturate = saturate
        self.min_time = float(min_time)
        self.max_time = float(max_time)
        # None = the reference default 1e5 (SURVEY.md C1); track whether the
        # user asked explicitly so the capacity clamp can warn only then.
        _explicit_max_nodes = max_nodes is not None
        self.max_nodes = int(1e5) if max_nodes is None else int(max_nodes)
        self.sys_time = sys_time
        self.printing = printing

        self.nstates = constraints.nstates
        self.ncontrols = constraints.ncontrols
        self.horizon_steps = max(int(round(self.horizon / self.dt)), 1)
        self.batch_size = int(batch_size)
        self.nn_block = int(nn_block)
        if capacity is None:
            capacity = min(self.max_nodes, 32768)
            if _explicit_max_nodes and self.max_nodes > capacity:
                import warnings
                hbm_mib = (self.max_nodes * 4
                           * self.horizon_steps
                           * (self.nstates + self.ncontrols)) / 2**20
                warnings.warn(
                    f"max_nodes={self.max_nodes} exceeds the default tree "
                    f"capacity {capacity}; planning stops at {capacity} "
                    f"nodes. Pass capacity={self.max_nodes} explicitly to "
                    f"honor max_nodes (~{hbm_mib:.0f} MiB of HBM for edge "
                    f"rollout storage).", stacklevel=2)
        elif self.max_nodes > int(capacity) and _explicit_max_nodes:
            import warnings
            warnings.warn(
                f"max_nodes={self.max_nodes} exceeds capacity={capacity}; "
                f"planning stops at {capacity} nodes.", stacklevel=2)
        # capacity rounded up to a multiple of the NN block for clean tiling;
        # slack rows (also block-aligned) enable the scatter-free dense commit
        blk = min(self.nn_block, capacity)
        self.capacity = -(-int(capacity) // blk) * blk
        self.slack = -(-self.batch_size // blk) * blk
        self.wrap_dims = tuple(wrap_dims)
        self.rounds_per_chunk = max(int(rounds_per_chunk), 1)
        self.nn_impl = nn_impl
        self.steer_impl = "scan"
        self.steer_selected = "scan"
        # Multi-device mode (SURVEY.md 2.4 P1/P2): candidate batch sharded
        # over mesh_axis, tree replicated, best-edge collective per round
        # ("gather" = full candidate all-gather, commit-everything; "topk" =
        # score gather + psum of the k globally-best edges).  The whole
        # chunked anytime loop — budget, kill, FPR, pruning, finish_on_goal,
        # extraction — works identically on a mesh.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.collective = collective
        self.topk = topk
        # P3 / P1 x P3 (SURVEY.md 2.4): occupancy grid row-sharded over the
        # mesh's ``map_axis``; every chunk runs the composed dp x map round
        # (parallel/map_sharded.py) with ONE collision psum per round.  The
        # grid's slabs ride the chunk as a sharded traced argument.
        self.feasibility_grid = feasibility_grid
        self.map_axis = map_axis
        self._grid_slab = None          # device-placed slabs, cached
        # refine=True: once the tree saturates its capacity, the anytime loop
        # STASHES the tree if it carries the best plan so far (one scalar
        # fetch + zero-copy handle keep), reseeds, and keeps growing — so the
        # remaining budget buys plan quality as the min over independent
        # trees, monotone in budget by construction.  Restart-stash replaced
        # round 2's in-place leaf-replacement refinement, which measurably
        # bought nothing: convergence-gated rewiring/shortcutting cannot fire
        # under LQR state tracking toward non-equilibrium targets (tree nodes
        # carry velocities; tracking a fixed moving-state orbits it, so the
        # ||erf|| <= error_tol acceptance essentially never triggers — see
        # core/rewire.py, which remains available for workloads where it
        # can).
        self.refine = bool(refine)
        # refine_mode once the tree saturates capacity:
        # "restart"     — anytime restart-stash (+ informed corridor
        #                 sampling): the measured winner on workloads whose
        #                 tree nodes carry velocities (boat/car/quad), where
        #                 convergence-gated rewiring cannot fire (see the
        #                 comment above).  Default.
        # "leaf_rewire" — in-place refinement: leaf replacement
        #                 (commit_batch_refine) + RRT*-style rewiring
        #                 (core/rewire.py).  Effective on near-equilibrium
        #                 workloads (e.g. double-integrator rest-to-rest)
        #                 where steering between stored states converges.
        if refine_mode not in ("restart", "leaf_rewire"):
            raise ValueError(f"unknown refine_mode {refine_mode!r}")
        if refine_mode == "leaf_rewire" and feasibility_grid is not None:
            raise ValueError("refine_mode='leaf_rewire' is not supported "
                             "with a sharded feasibility_grid")
        self.refine_mode = refine_mode
        # informed restarts: once a
        # restart has stashed a goal-reaching incumbent, this fraction of
        # every subsequent sample batch is drawn from the incumbent plan's
        # states + noise — corridor-biased restart trees find strictly
        # shorter arrivals than the plateau the unbiased restart-min reaches
        # (PERF.md, history).  The pool
        # and fraction ride the compiled chunk as TRACED arguments, so the
        # mechanism costs zero recompiles and is inert until an incumbent
        # exists (fraction 0.0).  Ignored when the caller passes xrand_gen.
        self.informed = float(informed)
        # informed_anneal < 1.0 shrinks the corridor-noise scale each time a
        # better incumbent lands.  On the boat it gave longer plans (annealing
        # kills the diversity that digs below the restart plateau; PERF.md,
        # history), so the knob is deprecated-in-place: default 1.0 is a
        # no-op and any other value warns.
        if informed_anneal != 1.0:
            import warnings
            warnings.warn(
                "informed_anneal != 1.0 measurably degrades anytime plan "
                "quality on the boat (see PERF.md); keep the default 1.0 "
                "unless you have measured otherwise on your workload",
                stacklevel=2)
        self.informed_anneal = float(informed_anneal)

        self._key = jax.random.PRNGKey(seed)
        self._feas_args = ()            # (data,) during a 3-arg-feas replan
        self._lqr_const = None          # lazily probed (see _lqr_is_constant)
        self.nn_selected = "jnp"        # backend actually picked at trace time
        self._chunk_cache = {}
        self._killed = False
        self.tree: Optional[Tree] = None           # host snapshot (lazy)
        self._device_tree: Optional[TreeArrays] = None
        # The committed plan is ONE tuple (x_seq, u_seq, T) swapped atomically
        # (GIL-atomic attribute store), so a controller thread interleaving
        # get_state/get_effort with a replan never sees a torn plan
        # (SURVEY.md section 5.2: the reference handles this informally the
        # same way; here it is an explicit invariant with a test).
        self._plan = None
        self.plan_reached_goal = False
        self.goal = None
        self.stats = {}
        self.on_replan: Optional[Callable] = None  # metrics hook (utils.metrics)

        # compiled lazily
        self._steer_jit = {}                       # batch size -> jitted steer
        self._seed_jit = None
        self._seed_tree_jit = None
        self._extract_jit = None
        self._goal_cost_jit = None
        self._score_jit = None

        if goal0 is not None:
            self.set_goal(goal0)

    # ------------------------------------------------------------------ setup

    def set_goal(self, goal):
        """Store the goal state (reference Planner.set_goal)."""
        goal = jnp.asarray(goal, jnp.float32)
        if goal.shape != (self.nstates,):
            raise ValueError(f"goal must have shape ({self.nstates},)")
        self.goal = goal

    def kill_update(self):
        """Preempt a running update_plan (reference C10); takes effect at the
        next chunk boundary (SURVEY.md section 3.4)."""
        self._killed = True

    def unkill(self):
        self._killed = False

    # ------------------------------------------------------------- jit plumbing

    def _wrap_mask(self):
        if not self.wrap_dims:
            return None
        wrap_mask = np.zeros(self.nstates, bool)
        wrap_mask[list(self.wrap_dims)] = True
        return wrap_mask

    def _lqr_is_constant(self) -> bool:
        """Probe whether lqr(x, u) is state-independent (one cost-to-go S for
        the whole tree, like the reference's precomputed-CARE demos).  Probes
        two distinct states eagerly at setup; any exception or mismatch (or
        non-finite output) falls back to the general per-node-S kernel.
        """
        if self._lqr_const is None:
            try:
                xa = jnp.zeros(self.nstates, jnp.float32)
                xb = jnp.full(self.nstates, 0.731, jnp.float32).at[
                    min(1, self.nstates - 1)].set(-0.417)
                ua = jnp.zeros(self.ncontrols, jnp.float32)
                ub = jnp.full(self.ncontrols, 0.293, jnp.float32)
                Sa, Ka = self.lqr(xa, ua)
                Sb, Kb = self.lqr(xb, ub)
                same = (np.all(np.isfinite(np.asarray(Sa)))
                        and np.allclose(np.asarray(Sa), np.asarray(Sb))
                        and np.allclose(np.asarray(Ka), np.asarray(Kb)))
                self._lqr_const = bool(same)
            except Exception:
                self._lqr_const = False
        return self._lqr_const

    def _nearest_override(self):
        """Pick the nearest-neighbour implementation for the chunk.

        The fused Pallas kernel (ops/pallas/nn_kernel.py, Triton route)
        needs an affine erf (subtract, optionally one wrapped angle dim) —
        make_erf products carry an ``angle_dims`` tag.  "auto" uses it on a
        GPU and the plain jnp scan (core/nearest.py) elsewhere; "pallas"
        forces it, compiled on a GPU and through the Pallas interpreter on
        the CPU (which is how the tests run it); "jnp" forces the plain
        scan.  The kernel's form follows the lqr probe: one shared
        cost-to-go S selects the whitened constant-metric form, otherwise
        the per-node form.  Returns None for the jnp path.
        """
        self.nn_selected = "jnp"
        if self.nn_impl == "jnp":
            return None
        dims = getattr(self.erf, "angle_dims", None)
        if self.erf in (jnp.subtract, np.subtract):
            dims = ()
        if dims is None or len(dims) > 1:
            if self.nn_impl == "pallas":
                raise ValueError(
                    "nn_impl='pallas' needs an affine erf with at most one "
                    "wrapped angle dim (build it with ops.angles.make_erf)")
            return None
        platform = jax.devices()[0].platform
        if self.nn_impl == "auto" and platform != "gpu":
            return None
        if platform not in ("gpu", "cpu"):
            raise ValueError(f"nn_impl='pallas' runs on a GPU (or "
                             f"interpreted on the CPU), not on {platform!r}")
        from .ops.pallas.nn_kernel import make_nearest_pallas
        const = self._lqr_is_constant()
        self.nn_selected = "pallas_const" if const else "pallas"
        return make_nearest_pallas(wrap_dim=dims[0] if dims else None,
                                   const_metric=const,
                                   interpret=(platform == "cpu"))

    def _get_chunk(self, xrand_gen, n_fpr: int, commit: str = "grow"):
        """Jitted chunk: rounds_per_chunk expansion rounds fused into one
        device program, returning (tree, packed [size, goal_found]) so the
        host pays exactly one dispatch + one small fetch per chunk.

        With ``mesh=`` set, the identical chunk runs as ONE shard_mapped
        program over the mesh: per round, sampling + NN + steering execute on
        each device's batch shard (P1), the best-edge collective (P2,
        ``collective=``) exchanges candidates between devices, and the
        replicated trees commit identically — so the whole anytime loop
        (budget, kill, FPR, pruning, finish_on_goal, extraction) is
        mesh-transparent.
        """
        # The generator OBJECT is part of the key (not id(): a GC'd lambda's
        # id can be reused, silently serving a stale chunk with the old
        # sampler).  The cache holds a strong reference; distinct generators
        # per planner are few, so growth is bounded in practice.
        key = (self.constraints._feasibility_version, xrand_gen, n_fpr,
               commit)
        if key in self._chunk_cache:
            return self._chunk_cache[key]

        # commit_all: the sort/gather-free dense commit (every candidate row
        # lands; empty rollouts as inert zero-length duplicates) — saves the
        # valid-first argsort + ~30 MB of reorder gathers per round at the
        # bench operating point.  ``size`` then counts committed rows; stats
        # report the honest n_live from the chunk stats vector.
        spec = RoundSpec(
            nstates=self.nstates, ncontrols=self.ncontrols,
            batch=self.batch_size, horizon_steps=self.horizon_steps,
            capacity=self.capacity, dt=self.dt, nn_block=self.nn_block,
            slack=self.slack, commit_all=(commit == "grow"
                                          and self.slack >= self.batch_size))
        wrap_mask = self._wrap_mask()
        nearest_fn = self._nearest_override()
        common = dict(wrap_mask=wrap_mask, saturate=self.saturate,
                      nearest_fn=nearest_fn)

        if self.mesh is not None:
            fn = self._build_mesh_chunk(spec, common, xrand_gen, n_fpr,
                                        commit)
            self._chunk_cache[key] = fn
            return fn

        user_feas = self.constraints.is_feasible
        uses_data = self.constraints.feasibility_data is not None
        informed_on = xrand_gen is None and self.informed > 0.0

        # ``extra`` traced args, in order: [prev_plan (FPR)], [feas_data],
        # [informed pool, informed frac].  All ride through the ONE compiled
        # chunk as traced arguments, so FPR replans, dynamic-obstacle
        # updates (SURVEY.md C9), and informed-restart pool refreshes never
        # retrace: values swap, code does not.
        def call(tree, k, goal, sample_space, goal_bias, bias_target,
                 *extra):
            ex = list(extra)
            inf_pool = inf_frac = inf_scale = None
            if informed_on:
                inf_scale = ex.pop()
                inf_frac = ex.pop()
                inf_pool = ex.pop()
            feas = user_feas
            if uses_data:
                data = ex.pop()
                feas = lambda x, u: user_feas(x, u, data)  # noqa: E731

            def base_sample(kk, B):
                fresh = sample_batch(kk, B, sample_space, goal_bias,
                                     bias_target)
                if not informed_on:
                    return fresh
                # informed-restart mixing: the first round(frac*B) rows come
                # from the incumbent-plan pool + exploration noise (inert
                # while frac == 0.0, i.e. before any goal incumbent exists);
                # the noise scale anneals as incumbents improve
                k2, k3 = jax.random.split(jax.random.fold_in(kk, 1))
                r = jax.random.randint(k2, (B,), 0, inf_pool.shape[0])
                scale = (sample_space[:, 1] - sample_space[:, 0]) * inf_scale
                noisy = inf_pool[r] + jax.random.normal(
                    k3, fresh.shape) * scale
                # honor the sampler's bounds contract: wrap angle dims, clip
                # the rest into sample_space (round-3 advisor: unclipped
                # noise wastes a fraction of every batch on out-of-box
                # targets)
                if wrap_mask is not None:
                    from .ops.angles import wrap_angle
                    noisy = jnp.where(jnp.asarray(wrap_mask),
                                      wrap_angle(noisy), noisy)
                noisy = jnp.clip(noisy, sample_space[:, 0],
                                 sample_space[:, 1])
                take = jnp.arange(B) < inf_frac * B
                return jnp.where(take[:, None], noisy, fresh)

            gen = xrand_gen if xrand_gen is not None else (
                base_sample if informed_on else None)
            if n_fpr > 0:
                # FPR warm start: n_fpr of each batch resampled from the
                # previous committed plan
                prev_plan = ex.pop(0)

                def gen(kk, B):
                    # B is a trace-time int that may be < batch_size (the
                    # refine round samples half batches): clamp the pool draw
                    k1, k2 = jax.random.split(kk)
                    n_take = min(n_fpr, B - 1)
                    fresh = base_sample(k1, B - n_take)
                    rows = jax.random.randint(k2, (n_take,), 0,
                                              prev_plan.shape[0])
                    return jnp.concatenate([prev_plan[rows], fresh], 0)
            if commit == "refine":
                # capacity-saturated: leaf replacement + rewiring, so the
                # remaining budget keeps shortening the committed plan
                fn = make_refine_round(
                    spec, self.dynamics, self.lqr, self.erf, feas,
                    self.error_tol, self.constraints.goal_buffer,
                    xrand_gen=gen, **common)
            else:
                fn = make_round(spec, self.dynamics, self.lqr, self.erf,
                                feas, self.error_tol,
                                self.constraints.goal_buffer,
                                xrand_gen=gen, commit=commit,
                                **common)
            return fn(tree, k, goal, sample_space, goal_bias, bias_target)

        n_inner = self.rounds_per_chunk

        def chunk(tree, base_key, start, goal, sample_space, goal_bias,
                  bias_target, *extra):
            def body(i, t):
                k = jax.random.fold_in(base_key, start + i)
                return call(t, k, goal, sample_space, goal_bias, bias_target,
                            *extra)
            tree = jax.lax.fori_loop(0, n_inner, body, tree)
            stats = _chunk_stats(tree)
            return tree, stats

        fn = jax.jit(chunk, donate_argnums=(0,))
        self._chunk_cache[key] = fn
        return fn

    def _build_mesh_chunk(self, spec, common, xrand_gen, n_fpr: int,
                          commit: str = "grow"):
        """Multi-device chunk (SURVEY.md 2.4 P1/P2): ONE jitted shard_map over
        ``mesh_axis`` runs rounds_per_chunk sharded rounds via lax.fori_loop —
        the same dispatch-amortization as the single-chip chunk, with the
        best-edge collective inside the loop.  All arguments and
        results are replicated (P()); the tree stays bit-identical across
        devices round after round (parallel/sharded.py invariant)."""
        from jax.sharding import PartitionSpec as P

        from .parallel.sharded import (make_sharded_round_body,
                                       mesh_axis_size, shard_map)

        n_dev = mesh_axis_size(self.mesh, self.mesh_axis)
        n_inner = self.rounds_per_chunk
        user_feas = self.constraints.is_feasible
        uses_data = self.constraints.feasibility_data is not None
        grid = self.feasibility_grid
        if grid is None:
            mk_body = dict(
                spec=spec, n_dev=n_dev, dynamics=self.dynamics, lqr=self.lqr,
                erf=self.erf, error_tol=self.error_tol,
                goal_buffer=self.constraints.goal_buffer,
                axis=self.mesh_axis, collective=self.collective,
                topk=self.topk, commit=commit, **common)
        else:
            # P3 / P1 x P3 composed chunk: the sharded-grid round body with
            # the slab threaded through the fori_loop as a sharded arg
            from .parallel.map_sharded import make_dp_map_round_body
            if commit != "grow":
                raise ValueError("feasibility_grid supports commit='grow' "
                                 "(the facade's restart-stash anytime path)")
            mk_body = dict(
                spec=spec, n_dp=n_dev, n_map=self.mesh.shape[self.map_axis],
                grid=grid, dynamics=self.dynamics, lqr=self.lqr,
                erf=self.erf, error_tol=self.error_tol,
                goal_buffer=self.constraints.goal_buffer,
                dp_axis=self.mesh_axis, map_axis=self.map_axis, **common)

        informed_on = xrand_gen is None and self.informed > 0.0

        def device_fn(tree, base_key, start, goal, sample_space, goal_bias,
                      bias_target, *extra):
            ex = list(extra)
            slab = ex.pop() if grid is not None else None
            inf_pool = inf_frac = inf_scale = None
            if informed_on:
                inf_scale = ex.pop()
                inf_frac = ex.pop()
                inf_pool = ex.pop()
            feas = user_feas
            if uses_data:
                # dynamic-obstacle data rides replicated through the chunk
                data = ex.pop()
                feas = lambda x, u: user_feas(x, u, data)  # noqa: E731

            def base_sample(kk, B):
                fresh = sample_batch(kk, B, sample_space, goal_bias,
                                     bias_target)
                if not informed_on:
                    return fresh
                # informed-restart mixing (see the single-chip chunk); pool,
                # frac and scale are replicated, the draw is per-device
                k2, k3 = jax.random.split(jax.random.fold_in(kk, 1))
                r = jax.random.randint(k2, (B,), 0, inf_pool.shape[0])
                scale = (sample_space[:, 1] - sample_space[:, 0]) * inf_scale
                noisy = inf_pool[r] + jax.random.normal(
                    k3, fresh.shape) * scale
                wm = common.get("wrap_mask")
                if wm is not None:
                    from .ops.angles import wrap_angle
                    noisy = jnp.where(jnp.asarray(wm), wrap_angle(noisy),
                                      noisy)
                noisy = jnp.clip(noisy, sample_space[:, 0],
                                 sample_space[:, 1])
                take = jnp.arange(B) < inf_frac * B
                return jnp.where(take[:, None], noisy, fresh)

            gen = xrand_gen if xrand_gen is not None else (
                base_sample if informed_on else None)
            if n_fpr > 0:
                # FPR warm start, sharded: each device draws its share of the
                # previous-plan resamples (the pool is replicated and tiny).
                prev_plan = ex.pop(0)
                n_loc = min(max(n_fpr // n_dev, 1), spec.batch // n_dev - 1)

                def gen(kk, B):
                    k1, k2 = jax.random.split(kk)
                    fresh = base_sample(k1, B - n_loc)
                    rows = jax.random.randint(k2, (n_loc,), 0,
                                              prev_plan.shape[0])
                    return jnp.concatenate([prev_plan[rows], fresh], 0)
            if grid is None:
                body = make_sharded_round_body(xrand_gen=gen,
                                               is_feasible=feas, **mk_body)

                def one(i, t):
                    k = jax.random.fold_in(base_key, start + i)
                    return body(t, k, goal, sample_space, goal_bias,
                                bias_target)
            else:
                body = make_dp_map_round_body(xrand_gen=gen,
                                              local_feasible=feas, **mk_body)

                def one(i, t):
                    k = jax.random.fold_in(base_key, start + i)
                    return body(t, slab, k, goal, sample_space, goal_bias,
                                bias_target)

            tree = jax.lax.fori_loop(0, n_inner, one, tree)
            stats = _chunk_stats(tree)
            return tree, stats

        rep = P()
        n_args = (7 + (1 if n_fpr > 0 else 0) + (1 if uses_data else 0)
                  + (3 if informed_on else 0))
        in_specs = (rep,) * n_args
        if grid is not None:
            in_specs = in_specs + (P(self.map_axis),)   # slab, shard-leading
        fn = shard_map(device_fn, mesh=self.mesh, in_specs=in_specs,
                       out_specs=(rep, rep), check_vma=False)
        return jax.jit(fn, donate_argnums=(0,))

    # score-vector layout of the fused-restart chunk, f32[6]:
    # [valid, s1 (0 = best has goal), s2 (goal time | cost-to-go),
    #  n_live of best, any_goal seen, best node id in the stashed tree]
    _RSCORE0 = (0.0, 1.0, np.inf, 1.0, 0.0, 0.0)

    def _get_restart_chunk(self, xrand_gen, n_fpr: int):
        """Fused-restart chunk: the ENTIRE anytime restart-stash policy runs
        on device (a host-loop restart cost a sync + two dispatch round
        trips per restart AND, with rounds_per_chunk > rounds-to-fill,
        dispatched rounds against an already-full tree that committed
        nothing).

        Key invariant: with commit_all (core/commit.py), a fresh tree's size
        grows by exactly ``batch`` per round, so the round at which it fills
        is STATIC: F = ceil((capacity-1)/batch).  A chunk therefore runs
        ``n_cycles`` fixed cycles of [F grow rounds -> stash-compare ->
        reseed], with zero data-dependent control flow:

        * stash-compare: score the filled tree ((goal?, time | cost), the
          same key _score_tree uses) and keep the better of (cur, best) via
          a full-tree select — predictable ~0.5 ms every F rounds, instead
          of a host sync + seed dispatch + pipeline bubble per restart.
        * informed pool: refreshed IN-CHUNK from the new incumbent when it
          improves and reaches the goal (same policy as the host loop, with
          zero staleness); the pool and the score ride the chunk carry.
        * reseed: row 0 (the root) is never overwritten by commits, so a
          reseed is just size=1 + goal_found=in_goal[0] + child-count clear
          — no 150 MB re-init dispatch.

        chunk(cur, best, pool, score, base_key, start, goal, sample_space,
              goal_bias, bias_target, *extra) -> (cur, best, pool, score)
        where extra = [prev_plan (FPR)] + [feas_data].  ``score`` is layout
        _RSCORE0; the host reads it as the per-chunk stats vector.
        """
        key = (self.constraints._feasibility_version, xrand_gen, n_fpr,
               "restart")
        if key in self._chunk_cache:
            return self._chunk_cache[key]

        from .core.rounds import commit_candidates, make_expand
        from .ops.angles import wrap_angle

        B = self.batch_size
        spec = RoundSpec(
            nstates=self.nstates, ncontrols=self.ncontrols, batch=B,
            horizon_steps=self.horizon_steps, capacity=self.capacity,
            dt=self.dt, nn_block=self.nn_block, slack=self.slack,
            commit_all=True)
        F = -(-(self.capacity - 1) // B)  # rounds to fill
        n_cycles = max(1, self.rounds_per_chunk // F)
        self._restart_chunk_shape = (n_cycles, F)
        wrap_mask = self._wrap_mask()
        nearest_fn = self._nearest_override()
        user_feas = self.constraints.is_feasible
        uses_data = self.constraints.feasibility_data is not None
        informed_on = xrand_gen is None and self.informed > 0.0
        inf_frac = float(self.informed)
        inf_scale = 0.05          # fixed: annealing is measured-harmful
        pool_fn = self._pool_fn()
        mesh = self.mesh
        if mesh is not None:
            from .parallel.sharded import (gather_candidates, mesh_axis_size,
                                           shard_map)
            n_dev = mesh_axis_size(mesh, self.mesh_axis)
        else:
            n_dev = 1
        local_b = B // n_dev

        def device_fn(cur, best, pool, score, base_key, start, goal,
                      sample_space, goal_bias, bias_target, *extra):
            ex = list(extra)
            feas = user_feas
            if uses_data:
                data = ex.pop()
                feas = lambda x, u: user_feas(x, u, data)  # noqa: E731
            prev_plan = ex.pop(0) if n_fpr > 0 else None
            expand = make_expand(spec, self.dynamics, self.lqr, self.erf,
                                 feas, self.error_tol,
                                 self.constraints.goal_buffer,
                                 wrap_mask=wrap_mask, saturate=self.saturate,
                                 nearest_fn=nearest_fn)

            def base_sample(kk, nb, pool_c, frac):
                fresh = sample_batch(kk, nb, sample_space, goal_bias,
                                     bias_target)
                if not informed_on:
                    return fresh
                k2, k3 = jax.random.split(jax.random.fold_in(kk, 1))
                r = jax.random.randint(k2, (nb,), 0, pool_c.shape[0])
                scale = (sample_space[:, 1] - sample_space[:, 0]) * inf_scale
                noisy = pool_c[r] + jax.random.normal(k3, fresh.shape) * scale
                if wrap_mask is not None:
                    noisy = jnp.where(jnp.asarray(wrap_mask),
                                      wrap_angle(noisy), noisy)
                noisy = jnp.clip(noisy, sample_space[:, 0],
                                 sample_space[:, 1])
                take = jnp.arange(nb) < frac * nb
                return jnp.where(take[:, None], noisy, fresh)

            def draw(kk, pool_c, frac):
                if xrand_gen is not None:
                    return xrand_gen(kk, local_b)
                if n_fpr > 0:
                    n_take = min(max(n_fpr // n_dev, 1), local_b - 1)
                    k1, k2 = jax.random.split(kk)
                    fresh = base_sample(k1, local_b - n_take, pool_c, frac)
                    rows = jax.random.randint(k2, (n_take,), 0,
                                              prev_plan.shape[0])
                    return jnp.concatenate([prev_plan[rows], fresh], 0)
                return base_sample(kk, local_b, pool_c, frac)

            def grow(cur_t, k, pool_c, frac):
                if mesh is not None:
                    k = jax.random.fold_in(
                        k, jax.lax.axis_index(self.mesh_axis))
                xrand = draw(k, pool_c, frac)
                cand = expand(cur_t, xrand, goal)
                if mesh is not None:
                    cand = gather_candidates(cand, self.mesh_axis)
                return commit_candidates(spec, cur_t, cand)

            def cycle(carry, c):
                cur_t, best_t, pool_c, sc = carry
                # informed fraction from the CURRENT incumbent (no staleness)
                frac = (jnp.where((sc[0] > 0.5) & (sc[1] < 0.5),
                                  inf_frac, 0.0) if informed_on else 0.0)

                def one(i, t):
                    k = jax.random.fold_in(base_key, start + c * F + i)
                    return grow(t, k, pool_c, frac)

                cur_t = jax.lax.fori_loop(0, F, one, cur_t)
                # ---- stash-compare (same key as _score_tree) ----
                b = best_node(cur_t)
                gf = cur_t.goal_found
                s1 = 1.0 - gf.astype(jnp.float32)
                s2 = jnp.where(gf, cur_t.node_time[b], cur_t.goal_cost[b])
                improved = ((sc[0] < 0.5) | (s1 < sc[1])
                            | ((s1 == sc[1]) & (s2 < sc[2])))
                live = (jnp.sum((cur_t.edge_len >= 1) & cur_t.valid_mask(),
                                dtype=jnp.int32) + 1).astype(jnp.float32)
                best_t = jax.tree.map(
                    lambda cu, be: jnp.where(improved, cu, be), cur_t,
                    best_t)
                new_sc = jnp.stack([
                    jnp.maximum(sc[0], 1.0),
                    jnp.where(improved, s1, sc[1]),
                    jnp.where(improved, s2, sc[2]),
                    jnp.where(improved, live, sc[3]),
                    jnp.maximum(sc[4], gf.astype(jnp.float32)),
                    jnp.where(improved, b.astype(jnp.float32), sc[5])])
                if informed_on:
                    refresh = improved & gf
                    pool_c = jnp.where(refresh, pool_fn(cur_t, b), pool_c)
                # ---- reseed (root row 0 is never overwritten by commits).
                # DEPTH PLANTING (round 5): each restart cycle can only grow
                # F = ceil(capacity/batch) edge generations (every round
                # attaches to the pre-round tree), so with the production
                # B=8192 / cap=32768 a plan needing >4 edges is unreachable
                # at ANY budget — measured on the two-wall hard boat
                # instance, where the best branch stalls mid-maze forever.
                # Reseed policy (round 5).  Before any goal: PLANT the
                # stash's best root-first chain (parents remapped linearly)
                # every cycle — deep instances are otherwise flat-out
                # unsolvable at any budget.  After a goal exists: ALTERNATE
                # bare reseeds (restart-min diversity, the measured
                # refinement mechanism on shallow instances — planting every
                # cycle froze the default boat 28%% above its floor) with
                # planted reseeds (tail refinement + re-reachability on
                # instances whose goal chains exceed F generations, where
                # bare cycles can never re-reach the goal and the incumbent
                # would otherwise freeze at first arrival). ----
                DP = 32                   # planted-prefix cap (static)
                no_goal_ever = new_sc[4] < 0.5
                gcyc = start // F + c              # global cycle counter
                bb = new_sc[5].astype(jnp.int32)   # best id in the stash

                def wstep(bcur, _):
                    nxt = jnp.where(bcur >= 0, best_t.parent[bcur], -1)
                    return nxt, bcur
                _, rev = jax.lax.scan(wstep, bb, None, length=DP)
                L = jnp.sum(rev >= 0)              # chain rows walked
                # a chain deeper than DP never reaches the root within the
                # walk — planting it would root the tree at a mid-state;
                # fall back to the bare reseed instead
                deeper = (L == DP) & (best_t.parent[rev[DP - 1]] >= 0)
                do_plant = (jnp.logical_not(deeper)
                            & (no_goal_ever | (gcyc % 2 == 1)))
                # Post-goal planted cycles alternate FULL-chain plants
                # (start goal-complete; refine arrivals along the chain)
                # with HALF-chain plants (keep the root-first half, force
                # the tail homotopy to be re-discovered) — full-chain-only
                # planting froze deep instances at their first arrival
                # because tail candidates rarely beat the incumbent
                # arrival, while the half plant leaves F generations of
                # genuinely open tail.
                Lp = jnp.where(no_goal_ever | (gcyc % 4 == 1), L,
                               jnp.maximum((L + 1) // 2, 1))
                idx = jnp.clip(Lp - 1 - jnp.arange(DP), 0, DP - 1)
                rows = jnp.maximum(rev[idx + (L - Lp)], 0)  # root-first ids
                valid = jnp.arange(DP) < Lp
                take = do_plant & valid            # (DP,) plant mask
                # Rows NOT taken are written as copies of best_t's row 0 —
                # the root, which is identical in cur/best (seeded from the
                # same x0, never overwritten by commits) and INERT: the NN
                # ties it with row 0 and the lowest index wins.  Writing all
                # DP rows every cycle also clears stale chain rows from a
                # previous planted reseed.
                rows = jnp.where(take, rows, 0)

                def plant(dst, src_rows):
                    return jax.lax.dynamic_update_slice(
                        dst, src_rows, (jnp.asarray(0, jnp.int32),)
                        + (jnp.asarray(0, jnp.int32),) * (dst.ndim - 1))

                def plant_tm(dst, src_cols):
                    # time-major edge buffers: node axis MINOR
                    z = jnp.asarray(0, jnp.int32)
                    return jax.lax.dynamic_update_slice(dst, src_cols,
                                                        (z, z, z))

                lin_parent = jnp.where(
                    take, jnp.arange(DP, dtype=jnp.int32) - 1, -1)
                n_child_pl = jnp.where(take & (jnp.arange(DP) < Lp - 1),
                                       1, 0).astype(jnp.int32)
                cur_t = cur_t._replace(
                    state=plant(cur_t.state, best_t.state[rows]),
                    S=plant(cur_t.S, best_t.S[rows]),
                    K=plant(cur_t.K, best_t.K[rows]),
                    parent=plant(cur_t.parent, lin_parent),
                    edge_x=plant_tm(cur_t.edge_x, best_t.edge_x[:, :, rows]),
                    edge_u=plant_tm(cur_t.edge_u, best_t.edge_u[:, :, rows]),
                    edge_len=plant(cur_t.edge_len, best_t.edge_len[rows]),
                    node_time=plant(cur_t.node_time,
                                    best_t.node_time[rows]),
                    in_goal=plant(cur_t.in_goal, best_t.in_goal[rows]),
                    goal_cost=plant(cur_t.goal_cost,
                                    best_t.goal_cost[rows]),
                    n_children=jnp.zeros_like(cur_t.n_children).at[:DP].set(
                        n_child_pl),
                    size=jnp.where(do_plant, jnp.minimum(Lp, DP),
                                   1).astype(jnp.int32),
                    goal_found=(best_t.in_goal[0]
                                | jnp.any(take & best_t.in_goal[rows])),
                )
                return (cur_t, best_t, pool_c, new_sc), None

            (cur, best, pool, score), _ = jax.lax.scan(
                cycle, (cur, best, pool, score),
                jnp.arange(n_cycles, dtype=jnp.int32))
            # stats ride out as a DISTINCT buffer: the carry score is donated
            # into the next chunk while the host still holds last chunk's
            # stats for the (pipelined, one-chunk-stale) break checks
            return cur, best, pool, score, score + 0.0

        if mesh is None:
            fn = jax.jit(device_fn, donate_argnums=(0, 1, 2, 3))
        else:
            from jax.sharding import PartitionSpec as P

            from .parallel.sharded import shard_map
            rep = P()
            n_args = (10 + (1 if n_fpr > 0 else 0) + (1 if uses_data else 0))
            fn = shard_map(device_fn, mesh=mesh, in_specs=(rep,) * n_args,
                           out_specs=(rep,) * 5, check_vma=False)
            fn = jax.jit(fn, donate_argnums=(0, 1, 2, 3))
        self._chunk_cache[key] = fn
        return fn

    def _score_tree(self, tree) -> tuple:
        """(orderable plan-quality key, best node id) for a tree, ONE tiny
        device fetch: goal trees first (shorter best goal time wins), then
        ascending LQR cost-to-go of the best node — the same criterion
        best_node uses.  Drives the anytime restart stash (lower = better)
        and the informed-restart pool refresh."""
        if self._score_jit is None:
            def score(t):
                b = best_node(t)
                return (t.goal_found,
                        jnp.where(t.goal_found, t.node_time[b], jnp.inf),
                        t.goal_cost[b], b)
            self._score_jit = jax.jit(score)
        g, d, c, b = jax.device_get(self._score_jit(tree))
        key = (0, float(d)) if bool(g) else (1, float(c))
        return key, int(b)

    _POOL_DEPTH = 64   # chain-walk cap for the on-device informed pool

    def _pool_fn(self):
        """Traceable pool(t, best) -> (_FPR_PLAN_LEN, n) states along the
        best node's root chain — shared by the host-loop refresh
        (_plan_pool_device) and the fused-restart chunk's in-chunk refresh."""
        D, P = self._POOL_DEPTH, _FPR_PLAN_LEN
        H = self.horizon_steps

        def pool(t, best):
            def step(cur, _):
                nxt = jnp.where(cur >= 0, t.parent[cur], -1)
                return nxt, cur
            _, ids = jax.lax.scan(step, best.astype(jnp.int32), None,
                                  length=D)              # leaf-first
            safe = jnp.clip(ids, 0, t.state.shape[0] - 1)
            # time-major storage: gather on the node axis, then bring
            # the chain axis up front (tiny: D*H rows)
            ex = jnp.transpose(t.edge_x[:, :, safe], (2, 0, 1))  # (D,H,n)
            el = t.edge_len[safe]
            mask = ((jnp.arange(H)[None, :] < el[:, None])
                    & (ids >= 0)[:, None])
            flat = ex.reshape(D * H, -1)
            fm = mask.reshape(D * H)
            cs = jnp.cumsum(fm)
            total = jnp.maximum(cs[-1], 1)
            # P evenly spaced valid entries (root state excluded; the
            # pool is a sampling bias target, exact coverage is moot)
            want = (jnp.arange(P) * total) // P + 1
            pos = jnp.searchsorted(cs, want)
            return flat[jnp.clip(pos, 0, D * H - 1)]

        return pool

    def _plan_pool_device(self, tree, best: int):
        """(_FPR_PLAN_LEN, n) pool of states along the best node's root
        chain, built ENTIRELY on device (one jitted program, result stays a
        device array): the informed-restart pool refresh must not sync the
        pipelined host loop — a host-side extraction here cost ~5% of
        headline throughput per improvement."""
        if getattr(self, "_pool_jit", None) is None:
            self._pool_jit = jax.jit(self._pool_fn())
        return self._pool_jit(tree, jnp.asarray(best, jnp.int32))

    def _get_seed_tree(self):
        """One jitted program seeds the whole tree at x0 — init_tree's dozen
        array initializations as eager ops cost a dispatch round-trip each on
        remote backends."""
        if self._seed_tree_jit is None:
            def seed_tree(x0, goal, goal_buffer):
                S0, K0 = self.lqr(x0, jnp.zeros(self.ncontrols))
                e0 = self.erf(goal, x0)
                in_goal0 = jnp.all(jnp.abs(e0) <= goal_buffer)
                g0 = _quad(e0, S0)
                return init_tree(self.capacity, self.horizon_steps,
                                 self.nstates, self.ncontrols, x0, S0, K0,
                                 g0, in_goal0, slack=self.slack)
            self._seed_tree_jit = jax.jit(seed_tree)
        return self._seed_tree_jit

    def _get_seed(self):
        if self._seed_jit is None:
            def seed(x0, goal, goal_buffer):
                S0, K0 = self.lqr(x0, jnp.zeros(self.ncontrols))
                e0 = self.erf(goal, x0)
                in_goal0 = jnp.all(jnp.abs(e0) <= goal_buffer)
                g0 = _quad(e0, S0)
                return S0, K0, in_goal0, g0
            self._seed_jit = jax.jit(seed)
        return self._seed_jit

    def _get_steer(self, batch: int, steps: Optional[int] = None):
        """Jitted batched steer, cached per (batch, horizon) shape (pruning
        uses the all-pairs batch; finish_on_goal a small extended-horizon
        tile).  With a 3-arg is_feasible(x, u, data) the returned function
        takes the obstacle data as a trailing traced argument (call sites
        append ``self._feas_args``)."""
        steps = self.horizon_steps if steps is None else steps
        key = (batch, steps, self.constraints._feasibility_version)
        if key not in self._steer_jit:
            if self.constraints.feasibility_data is not None:
                user_feas = self.constraints.is_feasible

                def steer_data(x0, K, xtar, data):
                    s = make_steer(self.dynamics, self.erf,
                                   lambda x, u: user_feas(x, u, data),
                                   steps, self.dt, self.error_tol,
                                   saturate=self.saturate)
                    return s(x0, K, xtar)
                self._steer_jit[key] = jax.jit(steer_data)
            else:
                steer = make_steer(self.dynamics, self.erf,
                                   self.constraints.is_feasible,
                                   steps, self.dt, self.error_tol,
                                   saturate=self.saturate)
                self._steer_jit[key] = jax.jit(steer)
        return self._steer_jit[key]

    # ---------------------------------------------------------------- warmup

    def warmup(self, x0, sample_space, goal_bias=0, guide=None,
               xrand_gen: Callable = None, pruning: bool = True):
        """Compile every program update_plan can dispatch, outside any timed
        budget: the grow chunk, seeding, extraction, the restart-stash score
        (which otherwise compiles lazily INSIDE the first replan that
        saturates capacity, so a late-compiling variant can land in the
        timed window), and (with ``pruning``) the shortcut-steer batch.

        Runs one tiny replan (specific_time=0.05); planner plan state is
        left as that tiny replan's.
        """
        self.update_plan(x0, sample_space, goal_bias=goal_bias, guide=guide,
                         xrand_gen=xrand_gen, pruning=pruning,
                         specific_time=0.05)
        fused = (self.refine
                 and min(self.max_nodes, self.capacity) >= self.capacity
                 and self.feasibility_grid is None
                 and self.slack >= self.batch_size)
        if self.refine and self._device_tree is not None and not fused:
            # host-loop restart path only: the fused chunk carries its own
            # score/pool, compiled by the update_plan call above
            self._score_tree(self._device_tree)   # compile the stash score
            if xrand_gen is None and self.informed > 0.0:
                jax.block_until_ready(               # compile the pool walk
                    self._plan_pool_device(self._device_tree, 0))

    # ------------------------------------------------------------ update_plan

    def update_plan(self, x0, sample_space, goal_bias=0, guide=None,
                    xrand_gen: Callable = None, pruning: bool = True,
                    finish_on_goal: bool = False,
                    specific_time: Optional[float] = None) -> bool:
        """Grow a tree from x0 until the time budget expires, then commit the
        best branch as the current plan (reference C2/C7, SURVEY.md 3.2).

        Returns True iff the tree reached the goal region.
        """
        if self.goal is None:
            raise RuntimeError("goal not set; call set_goal or pass goal0")
        self.unkill()
        x0 = jnp.asarray(x0, jnp.float32)
        if x0.shape != (self.nstates,):
            raise ValueError(f"x0 must have shape ({self.nstates},)")
        sample_space = jnp.asarray(sample_space, jnp.float32).reshape(
            self.nstates, 2)
        goal_bias = normalize_goal_bias(goal_bias, self.nstates)
        bias_target = self.goal if guide is None else jnp.asarray(
            guide, jnp.float32)

        if specific_time is not None:
            t_min = t_max = float(specific_time)
        else:
            t_min, t_max = self.min_time, self.max_time

        # FPR warm-start pool from the previous committed plan.  With no
        # previous plan yet, a straight-line x0->goal ramp stands in, so the
        # FPR>0 configuration always compiles exactly ONE chunk variant
        # (n_fpr is a trace-time constant).
        n_fpr = 0
        extra = ()
        if self.FPR > 0.0:
            n_fpr = max(int(round(self.FPR * self.batch_size)), 1)
            if self.x_seq is not None and len(self.x_seq) > 1:
                idx = np.linspace(0, len(self.x_seq) - 1, _FPR_PLAN_LEN)
                pool = np.asarray(self.x_seq)[idx.astype(int)]
            else:
                pool = np.linspace(np.asarray(x0), np.asarray(self.goal),
                                   _FPR_PLAN_LEN, dtype=np.float32)
            extra = (jnp.asarray(pool, jnp.float32),)

        # Dynamic-obstacle data (Constraints.set_feasibility_data, SURVEY.md
        # C9): fetched fresh each replan and threaded through as the last
        # traced chunk argument — value updates never recompile.
        if self.constraints.feasibility_data is not None:
            feas_data = jax.tree.map(jnp.asarray,
                                     self.constraints.feasibility_data)
            extra = extra + (feas_data,)
            self._feas_args = (feas_data,)
        else:
            self._feas_args = ()

        # Fused-restart fast path: when anytime restarts apply (stop is the
        # HBM capacity, no sharded grid, dense-commit slack), the whole
        # restart-stash policy runs ON DEVICE inside the chunk
        # (_get_restart_chunk) — no host sync, no seed dispatch, no wasted
        # post-fill rounds.  The host loop below remains for grid mode,
        # refine=False, and explicit max_nodes below capacity.
        node_cap = min(self.max_nodes, self.capacity)
        if (self.refine and self.refine_mode == "restart"
                and node_cap >= self.capacity
                and self.feasibility_grid is None
                and self.slack >= self.batch_size):
            return self._run_restart_loop(
                x0, sample_space, goal_bias, bias_target, t_min, t_max,
                xrand_gen, n_fpr, list(extra), pruning, finish_on_goal)

        # Informed-restart pool (traced, inert at frac 0.0 until a restart
        # stashes a goal incumbent; refreshed in the restart branch below).
        informed_on = xrand_gen is None and self.informed > 0.0
        extra = list(extra)
        inf_slot = None
        if informed_on:
            inf_slot = len(extra)
            pool0 = np.linspace(np.asarray(x0), np.asarray(self.goal),
                                _FPR_PLAN_LEN, dtype=np.float32)
            extra += [jnp.asarray(pool0), jnp.asarray(0.0, jnp.float32),
                      jnp.asarray(0.05, jnp.float32)]

        # Sharded-grid slabs (P3): device-placed once per planner, then ride
        # every chunk as the last (map-sharded) traced argument.
        if self.feasibility_grid is not None:
            if self._grid_slab is None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                self._grid_slab = jax.device_put(
                    jnp.asarray(self.feasibility_grid.occ_sharded),
                    NamedSharding(self.mesh, P(self.map_axis)))
            extra = extra + [self._grid_slab]

        chunk_fn = self._get_chunk(xrand_gen, n_fpr)

        # seed the tree at x0 (reference: Tree(seed_state=x0, seed_lqr=...))
        tree = self._get_seed_tree()(x0, self.goal,
                                     self.constraints.goal_buffer)
        if self.mesh is not None:
            from .parallel.sharded import replicate_tree
            tree = replicate_tree(tree, self.mesh)

        self._key, base = jax.random.split(self._key)
        t0 = self.sys_time()
        rounds = 0
        restarts = 0
        size, goal_found = 1, False
        node_cap = min(self.max_nodes, self.capacity)
        # Restart-stash refinement applies only when the stop is the HBM
        # capacity, not an explicit (reference-semantics) max_nodes below it.
        refine_on = self.refine and node_cap >= self.capacity
        if self.printing:
            print(f"[lqrrt] planning: budget [{t_min}, {t_max}]s, "
                  f"batch {self.batch_size} x {self.rounds_per_chunk} "
                  f"rounds/chunk, capacity {self.capacity}")
        # Pipelined anytime loop: dispatch chunk k+1 BEFORE fetching chunk
        # k's stats, so the host's one small fetch per chunk overlaps the
        # next chunk's device compute (JAX async dispatch).  Break checks see
        # stats one chunk stale — the same anytime semantics at one-chunk
        # granularity (SURVEY.md section 3.4).
        pending = None
        n_live = 1
        best_stash = None            # device tree carrying the best plan
        best_key, best_size = None, 1  # (0 if goal else 1, duration | gcost)
        pool_time = None             # incumbent time the informed pool holds
        inf_scale = 0.05             # corridor noise scale (anneals)
        overall_goal = goal_found
        while True:
            elapsed = self.sys_time() - t0
            if self._killed:
                if self.printing:
                    print("[lqrrt] killed; salvaging best-so-far")
                break
            if size >= node_cap:
                if not refine_on:
                    break
                if self.refine_mode == "leaf_rewire":
                    # In-place refinement: the remaining
                    # budget runs leaf-replacement + RRT* rewiring chunks on
                    # the SAME full tree (no reseed) — the right mode for
                    # near-equilibrium workloads where steering between
                    # stored states converges (core/rewire.py).  Swap the
                    # chunk variant (cached, idempotent) and fall through to
                    # the normal pipelined dispatch + budget checks below.
                    chunk_fn = self._get_chunk(xrand_gen, n_fpr,
                                               commit="refine")
                else:
                    # Anytime restart (SURVEY.md C2): stash this tree's
                    # handle if it carries the best plan so far, reseed, keep
                    # growing.  No copy needed — the stash keeps the only
                    # reference to the old buffers; donation only ever
                    # consumes the fresh seed tree.  The stash score rides
                    # the chunk's OWN stats vector (_chunk_stats), so a
                    # restart costs zero extra dispatches: one fetch of the
                    # in-flight chunk's stats, one seed dispatch.
                    st = np.asarray(pending)
                    pending = None
                    size = int(st[0])
                    n_live = int(st[5])
                    goal_cur = bool(st[1] > 0.5)
                    key_cur = ((0, float(st[2])) if goal_cur
                               else (1, float(st[3])))
                    best_id = int(st[4])
                    overall_goal |= goal_cur
                    improved = best_key is None or key_cur < best_key
                    if improved:
                        best_stash, best_key, best_size = tree, key_cur, n_live
                    if (inf_slot is not None and improved and key_cur[0] == 0
                            and (pool_time is None
                                 or key_cur[1] < pool_time - 0.05)):
                        # refresh the informed pool from the new incumbent plan:
                        # built ON DEVICE (chain walk + gather), result stays a
                        # device array — zero host sync in the pipelined loop
                        pool_time = key_cur[1]
                        extra[inf_slot] = self._plan_pool_device(tree, best_id)
                        extra[inf_slot + 1] = jnp.asarray(self.informed,
                                                          jnp.float32)
                        # optional corridor-noise annealing (default OFF:
                        # on the boat, shrinking the noise as incumbents
                        # improve kills the diversity that digs below the
                        # plateau; PERF.md, history)
                        inf_scale = max(self.informed_anneal * inf_scale,
                                        0.015)
                        extra[inf_slot + 2] = jnp.asarray(inf_scale, jnp.float32)
                    restarts += 1
                    tree = self._get_seed_tree()(x0, self.goal,
                                                 self.constraints.goal_buffer)
                    if self.mesh is not None:
                        from .parallel.sharded import replicate_tree
                        tree = replicate_tree(tree, self.mesh)
                    size, goal_found, pending = 1, False, None
            if elapsed >= t_max:
                break
            if (goal_found or overall_goal) and elapsed >= t_min:
                break
            tree, stats = chunk_fn(tree, base, rounds, self.goal,
                                   sample_space, goal_bias, bias_target,
                                   *extra)
            rounds += self.rounds_per_chunk
            if pending is not None:
                st = np.asarray(pending)     # one fetch, overlapped above
                size, goal_found = int(st[0]), bool(st[1])
                n_live = int(st[5])
            pending = stats
        key_fin = None
        if pending is not None:
            st = np.asarray(pending)         # final (current) stats
            size, goal_found = int(st[0]), bool(st[1] > 0.5)
            n_live = int(st[5])
            key_fin = ((0, float(st[2])) if goal_found
                       else (1, float(st[3])))
        elapsed = self.sys_time() - t0

        # Best of (final tree, stashed restarts) — the committed plan is the
        # min over every tree this budget grew (monotone in budget).
        if best_stash is not None:
            if key_fin is None:              # broke right after a restart
                key_fin, _ = self._score_tree(tree)
            overall_goal |= key_fin[0] == 0
            if key_fin < best_key:
                best_stash, best_key = tree, key_fin
            else:
                tree, n_live = best_stash, best_size
        self._device_tree = tree
        self.tree = None  # host snapshot invalidated; rebuilt lazily

        goal_reached = bool(overall_goal or goal_found)
        t_post = self.sys_time()
        best = int(best_node(tree))
        x_seq, u_seq = self._extract(tree, best)
        t_extract = self.sys_time() - t_post

        t_p = self.sys_time()
        if pruning and len(x_seq) > 2:
            x_seq, u_seq = self._prune(tree, x_seq, u_seq)
        t_prune = self.sys_time() - t_p
        t_f = self.sys_time()
        if finish_on_goal and goal_reached:
            x_seq, u_seq = self._finish_on_goal(x_seq, u_seq)
        t_finish = self.sys_time() - t_f

        x_seq = np.asarray(x_seq, np.float32)
        u_seq = np.asarray(u_seq, np.float32)
        self._plan = (x_seq, u_seq, self.dt * (len(x_seq) - 1))  # atomic swap
        self.plan_reached_goal = goal_reached
        self.stats = dict(
            nodes=n_live, tree_rows=size, rounds=rounds, restarts=restarts,
            elapsed_s=elapsed,
            expansions=rounds * self.batch_size,
            expansions_per_s=rounds * self.batch_size / max(elapsed, 1e-9),
            goal_found=goal_reached, plan_steps=len(self.x_seq),
            plan_duration_s=self.T,
            # post-loop overhead itemization
            overhead_extract_s=t_extract, overhead_prune_s=t_prune,
            overhead_finish_s=t_finish,
            overhead_total_s=self.sys_time() - t_post,
            total_s=self.sys_time() - t0)
        if self.printing:
            print(f"[lqrrt] done: {n_live} nodes, "
                  f"{rounds} rounds in {elapsed:.3f}s "
                  f"({self.stats['expansions_per_s']:.0f} expansions/s), "
                  f"goal={'yes' if goal_reached else 'no'}")
        if self.on_replan is not None:
            self.on_replan(dict(self.stats))
        return goal_reached

    def _run_restart_loop(self, x0, sample_space, goal_bias, bias_target,
                          t_min, t_max, xrand_gen, n_fpr: int, extra,
                          pruning: bool, finish_on_goal: bool) -> bool:
        """Anytime loop over fused-restart chunks (_get_restart_chunk): the
        host only dispatches chunks and reads one tiny stats vector per
        chunk, one chunk stale — every restart decision happens on device."""
        chunk_fn = self._get_restart_chunk(xrand_gen, n_fpr)
        n_cycles, F = self._restart_chunk_shape
        seed = self._get_seed_tree()
        gbuf = self.constraints.goal_buffer
        cur = seed(x0, self.goal, gbuf)
        best = seed(x0, self.goal, gbuf)
        if self.mesh is not None:
            from .parallel.sharded import replicate_tree
            cur = replicate_tree(cur, self.mesh)
            best = replicate_tree(best, self.mesh)
        pool = jnp.asarray(np.linspace(np.asarray(x0), np.asarray(self.goal),
                                       _FPR_PLAN_LEN, dtype=np.float32))
        score = jnp.asarray(self._RSCORE0, jnp.float32)
        self._key, base = jax.random.split(self._key)
        t0 = self.sys_time()
        rounds = 0
        restarts = 0
        any_goal = False
        pending = None
        if self.printing:
            print(f"[lqrrt] planning: budget [{t_min}, {t_max}]s, "
                  f"batch {self.batch_size} x {n_cycles}x{F} "
                  f"rounds/chunk (fused restarts), "
                  f"capacity {self.capacity}")
        while True:
            elapsed = self.sys_time() - t0
            if self._killed:
                if self.printing:
                    print("[lqrrt] killed; salvaging best-so-far")
                break
            if elapsed >= t_max:
                break
            if any_goal and elapsed >= t_min:
                break
            cur, best, pool, score, stats = chunk_fn(
                cur, best, pool, score, base, rounds, self.goal,
                sample_space, goal_bias, bias_target, *extra)
            rounds += n_cycles * F
            restarts += n_cycles
            if pending is not None:   # one-chunk-stale, overlapped fetch
                any_goal = bool(np.asarray(pending)[4] > 0.5)
            pending = stats
        st = (np.asarray(pending) if pending is not None
              else np.asarray(self._RSCORE0, np.float32))
        elapsed = self.sys_time() - t0

        self._device_tree = best
        self.tree = None
        goal_reached = bool(st[4] > 0.5)
        n_live = int(st[3])
        best_id = int(st[5])         # carried from the stash — no dispatch
        t_post = self.sys_time()
        x_seq, u_seq = self._extract(best, best_id)
        t_extract = self.sys_time() - t_post
        t_p = self.sys_time()
        if pruning and len(x_seq) > 2:
            x_seq, u_seq = self._prune(best, x_seq, u_seq)
        t_prune = self.sys_time() - t_p
        t_f = self.sys_time()
        if finish_on_goal and goal_reached:
            x_seq, u_seq = self._finish_on_goal(x_seq, u_seq)
        t_finish = self.sys_time() - t_f

        x_seq = np.asarray(x_seq, np.float32)
        u_seq = np.asarray(u_seq, np.float32)
        self._plan = (x_seq, u_seq, self.dt * (len(x_seq) - 1))  # atomic swap
        self.plan_reached_goal = goal_reached
        self.stats = dict(
            nodes=n_live,
            tree_rows=(self.capacity if st[0] > 0.5 else 1),
            rounds=rounds, restarts=restarts, elapsed_s=elapsed,
            expansions=rounds * self.batch_size,
            expansions_per_s=rounds * self.batch_size / max(elapsed, 1e-9),
            goal_found=goal_reached, plan_steps=len(self.x_seq),
            plan_duration_s=self.T,
            # post-loop overhead itemization
            overhead_extract_s=t_extract, overhead_prune_s=t_prune,
            overhead_finish_s=t_finish,
            overhead_total_s=self.sys_time() - t_post,
            total_s=self.sys_time() - t0)
        if self.printing:
            print(f"[lqrrt] done: {n_live} nodes, "
                  f"{rounds} rounds in {elapsed:.3f}s "
                  f"({self.stats['expansions_per_s']:.0f} expansions/s), "
                  f"goal={'yes' if goal_reached else 'no'}")
        if self.on_replan is not None:
            self.on_replan(dict(self.stats))
        return goal_reached

    # ------------------------------------------------- extraction & smoothing

    _EXTRACT_DEPTH = 128   # fixed-depth device chain walk (host fallback)

    def _extract(self, tree: TreeArrays, best: int):
        """Climb best -> root and concatenate trimmed edge rollouts
        (reference tree.climb + tree.trajectory, SURVEY.md C7/C8).

        ONE jitted program does the chain walk (fixed-depth parent scan),
        the edge gathers, and the device-side transposes; ONE device_get
        moves everything — a host-side parent fetch + walk would cost a
        full-array transfer and an extra round trip per replan.
        Chains deeper than _EXTRACT_DEPTH fall back to the host walk."""
        if self._extract_jit is None:
            D = self._EXTRACT_DEPTH

            def ext(t, b):
                def step(cur, _):
                    nxt = jnp.where(cur >= 0, t.parent[cur], -1)
                    return nxt, cur
                _, leaf_first = jax.lax.scan(step, b.astype(jnp.int32),
                                             None, length=D)
                ids = leaf_first[::-1]          # root-first, -1 pad at front
                safe = jnp.clip(ids, 0, t.state.shape[0] - 1)
                # edge storage is time-major (H, ·, N): gather on the node
                # axis, transpose the small (C, H, ·) result on device
                return (ids, t.state[safe], t.K[safe],
                        jnp.transpose(t.edge_x[:, :, safe], (2, 0, 1)),
                        jnp.transpose(t.edge_u[:, :, safe], (2, 0, 1)),
                        t.edge_len[safe])
            self._extract_jit = jax.jit(ext)
        out = jax.device_get(self._extract_jit(
            tree, jnp.asarray(best, jnp.int32)))
        ids, states, gains, edge_x, edge_u, edge_len = (
            np.asarray(a) for a in out)
        sel = np.flatnonzero(ids >= 0)
        if len(sel) == 0 or ids[sel[0]] != 0:
            return self._extract_host(tree, best)   # deeper than the walk
        chain = ids[sel]
        states, gains = states[sel], gains[sel]
        edge_x, edge_u, edge_len = edge_x[sel], edge_u[sel], edge_len[sel]
        self._last_chain = [int(i) for i in chain]
        self._last_edges = (states, gains, edge_x, edge_u, edge_len)
        xs = [states[0][None, :]]
        us = []
        for i in range(1, len(chain)):
            ln = int(edge_len[i])
            xs.append(edge_x[i][:ln])
            us.append(edge_u[i][:ln])
        x_seq = np.concatenate(xs, axis=0)
        u_seq = (np.concatenate(us, axis=0) if us
                 else np.zeros((0, self.ncontrols), np.float32))
        return x_seq, u_seq

    def _extract_host(self, tree: TreeArrays, best: int):
        """Host-walk extraction fallback for chains deeper than the fixed
        device walk (any depth; one parent-array fetch + one gather)."""
        parent = np.asarray(tree.parent)
        chain = []
        ID = best
        while ID != -1:
            chain.append(ID)
            ID = int(parent[ID])
        chain = chain[::-1]
        self._last_chain = chain
        if getattr(self, "_extract_gather_jit", None) is None:
            self._extract_gather_jit = jax.jit(lambda t, ids: (
                t.state[ids], t.K[ids],
                jnp.transpose(t.edge_x[:, :, ids], (2, 0, 1)),
                jnp.transpose(t.edge_u[:, :, ids], (2, 0, 1)),
                t.edge_len[ids]))
        out = self._extract_gather_jit(tree, jnp.asarray(chain, jnp.int32))
        states, gains, edge_x, edge_u, edge_len = (
            np.asarray(a) for a in jax.device_get(out))
        self._last_edges = (states, gains, edge_x, edge_u, edge_len)
        xs = [states[0][None, :]]
        us = []
        for i in range(1, len(chain)):
            ln = int(edge_len[i])
            xs.append(edge_x[i][:ln])
            us.append(edge_u[i][:ln])
        x_seq = np.concatenate(xs, axis=0)
        u_seq = (np.concatenate(us, axis=0) if us
                 else np.zeros((0, self.ncontrols), np.float32))
        return x_seq, u_seq

    def _prune(self, tree: TreeArrays, x_seq, u_seq):
        """Shortcut pass: re-steer between non-adjacent chain nodes and drop
        intermediates (reference pruning=True behavior, SURVEY.md C7).

        ONE batched steer evaluates every (source, target) chain pair at
        once; the greedy furthest-reachable selection then runs on the host
        from the (M, M) reached matrix, and only the chosen shortcut rollouts
        are fetched.  Chains longer than _PRUNE_MAX keep their tail unpruned
        (plans that deep are rare at practical horizons).
        """
        states, gains, edge_x, edge_u, edge_len = self._last_edges
        L = len(states)
        if L <= 3:
            # a 3-node chain admits only the 0->2 shortcut; the all-pairs
            # batch + its fetches cost more than it can save
            return x_seq, u_seq
        M = _PRUNE_MAX
        W = min(L, M)
        # padded (M, n) sources / (M, m, n) gains; all-pairs flattened batch
        src = np.zeros((M, self.nstates), np.float32)
        src[:W] = states[:W]
        gns = np.zeros((M,) + gains.shape[1:], np.float32)
        gns[:W] = gains[:W]
        x0_flat = np.repeat(src, M, axis=0)              # (M*M, n)
        K_flat = np.repeat(gns, M, axis=0)
        tgt_flat = np.tile(src, (M, 1))                  # (M*M, n)
        steer = self._get_steer(M * M)
        res = steer(jnp.asarray(x0_flat), jnp.asarray(K_flat),
                    jnp.asarray(tgt_flat), *self._feas_args)
        # one pytree device_get: the leaves transfer together instead of a
        # blocking round trip each
        reached, length = jax.device_get((res.reached, res.length))
        reached = np.asarray(reached).reshape(M, M)
        length = np.asarray(length).reshape(M, M)
        if self.feasibility_grid is not None:
            # the shortcut steer checks only the local predicates; validate
            # candidate shortcuts against the FULL grid host-side (the
            # sharded slabs are a host array too) before the greedy pick
            pos = tuple(int(d) for d in self.feasibility_grid.pos_dims)
            xs_all = np.asarray(res.x_seq)                    # (M*M, H, n)
            occ = self.feasibility_grid.occupied_host(xs_all[..., pos])
            steps = np.arange(occ.shape[1])[None, :]
            bad = (occ & (steps < np.asarray(res.length)[:, None])).any(1)
            reached = reached & ~bad.reshape(M, M)

        # greedy furthest-reachable shortcut over the window [0, W)
        segs = []          # (kind, i, j): "steer" uses res, "edge" original
        i = 0
        while i < W - 1:
            js = [j for j in range(W - 1, i + 1, -1)
                  if reached[i, j] and length[i, j] >= 1]
            if js:
                j = js[0]
                segs.append(("steer", i, j))
            else:
                j = i + 1
                segs.append(("edge", i, j))
            i = j
        # tail beyond the window: original edges
        for j in range(W, L):
            segs.append(("edge", j - 1, j))

        steer_pairs = [(i, j) for kind, i, j in segs if kind == "steer"]
        if not steer_pairs:
            return x_seq, u_seq
        # fetch only the chosen shortcut rollouts, one gather + one transfer
        flat_ids = jnp.asarray(
            np.array([i * M + j for i, j in steer_pairs], np.int32))
        sx, su = (np.asarray(a) for a in jax.device_get(
            (res.x_seq[flat_ids], res.u_seq[flat_ids])))
        sl = {p: k for k, p in enumerate(steer_pairs)}

        xs = [states[0][None, :]]
        us = []
        for kind, i, j in segs:
            if kind == "steer":
                k = sl[(i, j)]
                ln = int(length[i, j])
                xs.append(sx[k][:ln])
                us.append(su[k][:ln])
            else:
                ln = int(edge_len[j])
                xs.append(edge_x[j][:ln])
                us.append(edge_u[j][:ln])
        x_new = np.concatenate(xs, axis=0)
        u_new = (np.concatenate(us, axis=0) if us
                 else np.zeros((0, self.ncontrols), np.float32))
        # only accept if it actually shortens the plan
        if len(x_new) < len(x_seq):
            return x_new, u_new
        return x_seq, u_seq

    def _finish_on_goal(self, x_seq, u_seq):
        """Force an exact terminal connection to the goal (reference
        finish_on_goal=True / _steer(..., force_arrive=True), SURVEY.md C7).

        The in-tree steers use the planning horizon, but a forced arrival is
        a terminal maneuver: closing the last ~goal_buffer of error AND
        killing velocity to error_tol precision routinely needs longer than
        one horizon (a drag-limited boat takes many seconds to settle).  So
        this steer runs at 3x horizon; if it still falls short of error_tol,
        the best-improving prefix (the step whose S-weighted goal error is
        smallest, if smaller than the current endpoint's) is appended — the
        plan always ends at least as close to the goal as without it.
        """
        steer = self._get_steer(_FINISH_BATCH, steps=3 * self.horizon_steps)
        x_end = jnp.tile(jnp.asarray(x_seq[-1])[None, :], (_FINISH_BATCH, 1))
        Sg, Kg, _, _ = self._get_seed()(jnp.asarray(x_seq[-1]), self.goal,
                                        self.constraints.goal_buffer)
        res = steer(x_end, jnp.tile(Kg[None], (_FINISH_BATCH, 1, 1)),
                    jnp.tile(self.goal[None, :], (_FINISH_BATCH, 1)),
                    *self._feas_args)
        ln = int(np.asarray(res.length)[0])
        if bool(np.asarray(res.reached)[0]):
            cut = ln
        elif ln >= 1:
            # Best-improving prefix under the goal's S-weighted error norm,
            # evaluated as ONE jitted program (an eager per-step erf loop
            # would pay a device dispatch per rollout step).
            if self._goal_cost_jit is None:
                def goal_costs(xs, x_last, goal, S):
                    e = jax.vmap(self.erf, in_axes=(None, 0))(goal, xs)
                    costs = jnp.einsum("ti,ij,tj->t", e, S, e,
                                       precision=jax.lax.Precision.HIGHEST)
                    e0 = self.erf(goal, x_last)
                    return costs, _quad(e0, S)
                self._goal_cost_jit = jax.jit(goal_costs)
            costs, cur = self._goal_cost_jit(
                res.x_seq[0], jnp.asarray(x_seq[-1]), self.goal, Sg)
            costs = np.asarray(costs)[:ln]
            k = int(np.argmin(costs))
            cut = k + 1 if costs[k] < float(cur) else 0
        else:
            cut = 0
        if self.feasibility_grid is not None and cut >= 1:
            # keep only the grid-feasible prefix of the terminal connection
            pos = tuple(int(d) for d in self.feasibility_grid.pos_dims)
            xs = np.asarray(res.x_seq)[0][:cut]
            occ = self.feasibility_grid.occupied_host(xs[:, pos])
            if occ.any():
                cut = int(np.argmax(occ))
        if cut >= 1:
            x_seq = np.concatenate([x_seq, np.asarray(res.x_seq)[0][:cut]], 0)
            u_seq = np.concatenate(
                [u_seq, np.asarray(res.u_seq)[0][:cut]], 0) if len(u_seq) \
                else np.asarray(res.u_seq)[0][:cut]
        return x_seq, u_seq

    # --------------------------------------------------- controller-facing API

    @property
    def x_seq(self):
        """Committed plan states (P, n); None before the first plan."""
        plan = self._plan
        return None if plan is None else plan[0]

    @property
    def u_seq(self):
        """Committed plan efforts (P-1, m); None before the first plan."""
        plan = self._plan
        return None if plan is None else plan[1]

    @property
    def T(self) -> float:
        """Committed plan duration in seconds (0 before the first plan)."""
        plan = self._plan
        return 0.0 if plan is None else plan[2]

    def get_state(self, t: float):
        """Plan state at time t (s, relative to plan start), linear
        interpolation, endpoint hold outside [0, T] (reference C11)."""
        plan = self._plan  # single read: consistent even mid-replan-swap
        if plan is None:
            raise RuntimeError("no plan committed; call update_plan first")
        return self._interp(plan[0], t)

    def get_effort(self, t: float):
        """Plan effort at time t: linear interpolation between effort
        samples, endpoint hold outside the plan (reference C11 — SURVEY.md
        reconstructs the reference's get_effort as the same linear
        interpolation get_state uses [MED]; round 2 shipped ZOH, the last
        literal C11 delta)."""
        plan = self._plan
        if plan is None:
            raise RuntimeError("no plan committed; call update_plan first")
        u_seq = plan[1]
        if len(u_seq) == 0:
            return np.zeros(self.ncontrols, np.float32)
        tau = np.clip(t / self.dt, 0.0, len(u_seq) - 1)
        i = int(np.floor(tau))
        j = min(i + 1, len(u_seq) - 1)
        a = tau - i
        return (1.0 - a) * u_seq[i] + a * u_seq[j]

    def _interp(self, seq, t: float):
        tau = np.clip(t / self.dt, 0.0, len(seq) - 1)
        i = int(np.floor(tau))
        j = min(i + 1, len(seq) - 1)
        a = tau - i
        out = (1.0 - a) * seq[i] + a * seq[j]
        if self.wrap_dims:
            # Stored plan angles are wrapped into [-pi, pi); interpolate
            # across the seam via the wrapped delta so a 3.13 -> -3.13 step
            # reads as +0.02 rad, not a sweep through zero.
            two_pi = 2.0 * np.pi
            for d in self.wrap_dims:
                delta = (seq[j][d] - seq[i][d] + np.pi) % two_pi - np.pi
                ang = seq[i][d] + a * delta
                out[d] = (ang + np.pi) % two_pi - np.pi
        return out

    # ------------------------------------------------------------------ extras

    def get_tree(self) -> Tree:
        """Host snapshot of the last planning tree (reference-compatible)."""
        if self.tree is None:
            if self._device_tree is None:
                raise RuntimeError("no tree; call update_plan first")
            self.tree = Tree.from_device_arrays(self._device_tree)
        return self.tree

    def visualize(self, dx: int = 0, dy: int = 1, ax=None, show: bool = True):
        """matplotlib plot of tree + plan projected on dims (dx, dy)
        (reference C12)."""
        from .viz import visualize_planner
        return visualize_planner(self, dx, dy, ax=ax, show=show)

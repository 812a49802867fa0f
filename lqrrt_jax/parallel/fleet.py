"""Scenario parallelism (P4): many independent planner instances at once.

BASELINE.json config 5, fleet replanning: 1k simultaneous boat scenarios
sharded across devices.  Each scenario owns its own
fixed-capacity tree; the expansion round is vmapped over the scenario axis and
the scenario axis is sharded over the mesh — pure data parallelism with zero
cross-scenario communication, so scaling is limited only by HBM capacity.

All scenarios share the same model (dynamics/lqr/erf/feasibility); start
states, goals, sample spaces, and PRNG streams are per-scenario.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.rounds import RoundSpec, make_round
from ..core.tree import TreeArrays, best_node, init_tree


class FleetPlanner:
    """Batched fleet of planners over a (optionally sharded) scenario axis.

    Compared to the host Planner facade this is a throughput-oriented API:
    one ``plan(...)`` call grows all scenario trees for a fixed number of
    rounds (or until a wall-clock budget) and returns per-scenario results.
    """

    def __init__(self, dynamics: Callable, lqr: Callable, erf: Callable,
                 is_feasible: Callable, goal_buffer, horizon: float,
                 dt: float = 0.05, error_tol=0.05, *,
                 n_scenarios: int, batch_size: int = 256,
                 capacity: int = 4096, nn_block: int = 1024,
                 saturate: Optional[Callable] = None, wrap_dims=(),
                 mesh: Optional[Mesh] = None, axis: str = "scenario",
                 seed: int = 0, ncontrols: Optional[int] = None,
                 sys_time: Callable = None, per_scenario_data: bool = False):
        """``per_scenario_data=True``: ``is_feasible(x, u, data)`` is 3-arg
        and ``plan(..., feasibility_data=pytree)`` threads a PER-SCENARIO
        obstacle pytree (leading axis = scenario, sharded with the trees) as
        a traced argument — every boat sees its own world, zero recompiles
        on data updates (the fleet analog of Constraints.set_feasibility_data,
        SURVEY.md C9)."""
        self.n_scenarios = int(n_scenarios)
        self.per_scenario_data = bool(per_scenario_data)
        self.dt = float(dt)
        self.horizon_steps = max(int(round(horizon / dt)), 1)
        self.nstates = None  # resolved at plan() from x0 shape
        self.ncontrols = None if ncontrols is None else int(ncontrols)
        self.goal_buffer = np.asarray(goal_buffer, np.float32)
        self.mesh = mesh
        self.axis = axis
        self._key = jax.random.PRNGKey(seed)
        self.sys_time = sys_time if sys_time is not None else time.time
        self.spec = RoundSpec(
            nstates=-1, ncontrols=-1, batch=int(batch_size),
            horizon_steps=self.horizon_steps, capacity=int(capacity),
            dt=self.dt, nn_block=int(nn_block))
        self._mk = dict(dynamics=dynamics, lqr=lqr, erf=erf,
                        is_feasible=is_feasible, error_tol=error_tol,
                        saturate=saturate, wrap_dims=tuple(wrap_dims))
        self._vplan = None
        self._lqr = lqr
        self._erf = erf
        self.trees: Optional[TreeArrays] = None  # scenario-leading pytree

    def _build(self, nstates: int, ncontrols: int):
        blk = min(self.spec.nn_block, self.spec.capacity)
        slack = -(-self.spec.batch // blk) * blk  # dense-commit spare rows
        self.spec = self.spec._replace(nstates=nstates, ncontrols=ncontrols,
                                       slack=slack)
        wrap_mask = None
        if self._mk["wrap_dims"]:
            wrap_mask = np.zeros(nstates, bool)
            wrap_mask[list(self._mk["wrap_dims"])] = True
        user_feas = self._mk["is_feasible"]
        mk = dict(wrap_mask=wrap_mask, saturate=self._mk["saturate"])

        def round_one(tree, key, goal, sample_space, goal_bias, bias, data):
            feas = user_feas
            if self.per_scenario_data:
                feas = lambda x, u: user_feas(x, u, data)  # noqa: E731
            fn = make_round(self.spec, self._mk["dynamics"], self._mk["lqr"],
                            self._mk["erf"], feas, self._mk["error_tol"],
                            self.goal_buffer, **mk)
            return fn(tree, key, goal, sample_space, goal_bias, bias)

        vround = jax.vmap(round_one, in_axes=(0, 0, 0, 0, None, 0, 0))
        S = self.n_scenarios

        # All rounds fused into ONE dispatch (lax.fori_loop with a traced
        # trip count compiles once for any round count): per-round host
        # dispatch would be bound by dispatch latency.
        def run(trees, base, nrounds, goals, sample_spaces, goal_bias, data):
            def body(r, ts):
                keys = jax.random.split(jax.random.fold_in(base, r), S)
                return vround(ts, keys, goals, sample_spaces, goal_bias,
                              goals, data)
            return jax.lax.fori_loop(0, nrounds, body, trees)

        if self.mesh is not None:
            sh = NamedSharding(self.mesh, P(self.axis))
            rep = NamedSharding(self.mesh, P())
            tree_sh = jax.tree.map(lambda _: sh, _tree_proto())
            self._vplan = jax.jit(
                run, donate_argnums=(0,),
                in_shardings=(tree_sh, rep, rep, sh, sh, rep, sh),
                out_shardings=tree_sh)
        else:
            self._vplan = jax.jit(run, donate_argnums=(0,))
        # vmapped seeding
        def seed_one(x0, goal):
            S0, K0 = self._mk["lqr"](x0, jnp.zeros(ncontrols))
            e0 = self._mk["erf"](goal, x0)
            in_goal0 = jnp.all(jnp.abs(e0) <= self.goal_buffer)
            hi = jax.lax.Precision.HIGHEST
            g0 = jnp.dot(e0, jnp.dot(S0, e0, precision=hi), precision=hi)
            return init_tree(self.spec.capacity, self.spec.horizon_steps,
                             nstates, ncontrols, x0, S0, K0, g0, in_goal0,
                             slack=self.spec.slack)
        self._vseed = jax.jit(jax.vmap(seed_one))

    def plan(self, x0s, goals, sample_spaces, goal_bias, rounds: int = 10,
             max_time: Optional[float] = None, rounds_per_chunk: int = 8,
             feasibility_data=None):
        """Grow all scenario trees; returns stats dict.

        x0s: (S, n); goals: (S, n); sample_spaces: (S, n, 2) or (n, 2)
        shared; goal_bias: (n,) shared; feasibility_data: per-scenario
        obstacle pytree, leading axis S (requires per_scenario_data=True).

        Budget semantics (anytime, like Planner.update_plan): with
        ``max_time=None``, exactly ``rounds`` rounds run as ONE device
        dispatch.  With ``max_time`` set, chunks of up to
        ``rounds_per_chunk`` rounds are dispatched until the wall clock
        (``sys_time``) budget expires or ``rounds`` is reached; the nrounds
        argument is traced, so every chunk reuses one compiled program, and
        the LAST chunk is clamped to the rounds the remaining budget can
        afford (measured per-round wall time), keeping overshoot small
       .
        Per-scenario time-to-first-goal is recorded at chunk granularity.
        """
        x0s = jnp.asarray(x0s, jnp.float32)
        goals = jnp.asarray(goals, jnp.float32)
        S_, n = x0s.shape
        assert S_ == self.n_scenarios
        sample_spaces = jnp.asarray(sample_spaces, jnp.float32)
        if sample_spaces.ndim == 2:
            sample_spaces = jnp.broadcast_to(sample_spaces[None],
                                             (S_, n, 2))
        goal_bias = jnp.asarray(goal_bias, jnp.float32)
        if goal_bias.ndim == 0:
            goal_bias = jnp.full((n,), goal_bias)
        if self.per_scenario_data:
            if feasibility_data is None:
                raise ValueError("per_scenario_data=True requires "
                                 "feasibility_data=")
            data = jax.tree.map(jnp.asarray, feasibility_data)
        else:
            data = jnp.zeros((S_, 1), jnp.float32)   # shape-stable dummy

        if self._vplan is None or self.spec.nstates != n:
            m = (self.ncontrols if self.ncontrols is not None
                 else self._infer_ncontrols(x0s[0]))
            self._build(n, m)

        trees = self._vseed(x0s, goals)
        if self.mesh is not None:
            sh = NamedSharding(self.mesh, P(self.axis))
            trees = jax.tree.map(lambda x: jax.device_put(x, sh), trees)
            data = jax.tree.map(lambda x: jax.device_put(x, sh), data)
        self._key, base = jax.random.split(self._key)
        if max_time is not None:
            # Compile (and warm) _vplan OUTSIDE the timed budget: a cold
            # plan() otherwise pays trace+compile inside the first timed
            # chunk and can overshoot max_time arbitrarily (round-3 advisor
            # medium finding).  nr=0 runs the full compiled program as a
            # no-op fori_loop, leaving the seeded trees unchanged.
            trees = self._vplan(trees, base, jnp.asarray(0, jnp.int32),
                                goals, sample_spaces, goal_bias, data)
            trees.size.block_until_ready()
        t0 = self.sys_time()
        goal_time = np.full(S_, np.nan, np.float32)
        if max_time is None:
            trees = self._vplan(trees, base, jnp.asarray(rounds, jnp.int32),
                                goals, sample_spaces, goal_bias, data)
            done = rounds
        else:
            done = 0
            # EMA of measured wall s/round, PERSISTED across plan() calls so
            # a warm-up call seeds the very first chunk's clamp (the first
            # chunk otherwise dispatches rounds_per_chunk blind and can
            # overshoot a short budget by itself)
            per_round_s = getattr(self, "_per_round_s", None)
            while done < rounds:
                remaining_s = max_time - (self.sys_time() - t0)
                if remaining_s <= 0:
                    break
                nr = min(rounds_per_chunk, rounds - done)
                if per_round_s is None:
                    # 1-round probing chunk: with no wall-s/round estimate
                    # yet, a blind rounds_per_chunk dispatch is the one way
                    # left to overshoot a short budget; the probe bounds the
                    # first chunk's overshoot to a single round.
                    nr = 1
                else:
                    # clamp the last chunk to what the budget can afford
                    afford = max(int(remaining_s / per_round_s), 1)
                    nr = min(nr, afford)
                tc = self.sys_time()
                trees = self._vplan(trees, jax.random.fold_in(base, done),
                                    jnp.asarray(nr, jnp.int32),
                                    goals, sample_spaces, goal_bias, data)
                found = self._fetch(trees.goal_found)  # also syncs the chunk
                dt_chunk = max(self.sys_time() - tc, 1e-6) / nr
                per_round_s = (dt_chunk if per_round_s is None
                               else 0.5 * per_round_s + 0.5 * dt_chunk)
                self._per_round_s = per_round_s
                done += nr
                now = self.sys_time() - t0
                goal_time = np.where(np.isnan(goal_time) & found,
                                     np.float32(now), goal_time)
        trees.size.block_until_ready()
        elapsed = self.sys_time() - t0
        self.trees = trees
        found = self._fetch(trees.goal_found)
        if max_time is None:
            goal_time = np.where(found, np.float32(elapsed), goal_time)
        expansions = done * self.spec.batch * self.n_scenarios
        return dict(
            sizes=self._fetch(trees.size),
            goal_found=found,
            rounds=done,
            elapsed_s=elapsed,
            expansions=expansions,
            expansions_per_s=expansions / max(elapsed, 1e-9),
            goal_time_s=goal_time,
        )

    @staticmethod
    def _fetch(x):
        """np.asarray that works when the scenario axis spans processes:
        multi-process global arrays are not locally addressable, so gather
        them with the standard multihost utility first (P5)."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return np.asarray(
                multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(x)

    def _infer_ncontrols(self, x0):
        # Read K's leading dim from one lqr evaluation.  Re-linearized lqr
        # callbacks that use ``u`` (e.g. the car model without u_eq) cannot
        # be probed with u=None — those callers must pass ncontrols=.
        try:
            _, K0 = self._mk["lqr"](jnp.asarray(x0), None)
        except Exception as e:
            raise ValueError(
                "could not infer ncontrols by probing lqr(x0, None) — the "
                "lqr callback appears to use its u argument; pass "
                "ncontrols= to FleetPlanner explicitly") from e
        return int(np.asarray(K0).shape[0])

    _MAX_DEPTH = 128   # chain-walk cap for the batched extraction

    def best_nodes(self):
        return np.asarray(jax.jit(jax.vmap(best_node))(self.trees))

    def _get_chains_jit(self):
        """One vmapped program: per-scenario best node + root->best id chain
        (padded with -1), via a fixed-depth parent walk."""
        if getattr(self, "_chains_jit", None) is None:
            D = self._MAX_DEPTH

            def chains_one(t):
                best = best_node(t)

                def step(cur, _):
                    nxt = jnp.where(cur >= 0, t.parent[cur], -1)
                    return nxt, cur
                _, ids = jax.lax.scan(step, best.astype(jnp.int32), None,
                                      length=D)
                return ids[::-1]          # root-first, -1 padded at front

            self._chains_jit = jax.jit(jax.vmap(chains_one))
        return self._chains_jit

    def extract_plans(self, scenarios=None):
        """Batched plan extraction: ONE vmapped chain walk + ONE flat edge
        gather + ONE device->host transfer for every requested scenario —
        replacing the per-scenario host climb loop (1024 sequential
        device_get chains at fleet scale).

        Returns {scenario: (P_s, n) x_seq}.
        """
        if self.trees is None:
            raise RuntimeError("no trees; call plan() first")
        scenarios = (range(self.n_scenarios) if scenarios is None
                     else list(scenarios))
        tm = {}
        t0 = time.time()
        chains = np.asarray(self._get_chains_jit()(self.trees))  # (S, D)
        tm["chain_walk_s"] = time.time() - t0
        t0 = time.time()
        # Per-scenario root-first id chains.  The fixed-depth device walk
        # covers depth <= _MAX_DEPTH; any deeper chain is finished with a
        # host parent walk (rare — only very deep trees), so plans of ANY
        # depth extract correctly (round-3 advisor: the old bare assert
        # raised, or silently truncated under -O).
        id_lists = {}
        for s in scenarios:
            ids = [int(i) for i in chains[s] if i >= 0]
            if ids[0] != 0:
                parent = np.asarray(self.trees.parent[s])
                cur = int(parent[ids[0]])
                guard = 0
                while cur != -1:
                    ids.insert(0, cur)
                    cur = int(parent[cur])
                    guard += 1
                    if guard > parent.shape[0]:
                        raise RuntimeError(
                            f"scenario {s}: parent cycle during extraction")
                if ids[0] != 0:
                    raise RuntimeError(
                        f"scenario {s}: chain does not reach the root")
            id_lists[s] = ids
        # Dense (n_req, D) chain-id matrix, -1 padded; D static per call
        # (rounded up so distinct compiles stay few).
        req = list(scenarios)
        D = max(len(id_lists[s]) for s in req)
        D = -(-D // 8) * 8
        ids_mat = np.full((len(req), D), -1, np.int32)
        srow = np.empty(len(req), np.int32)
        for r, s in enumerate(req):
            ids = id_lists[s]
            ids_mat[r, :len(ids)] = ids
            srow[r] = s
        pairs = []                          # flat (row, chain-pos) pairs
        for r, s in enumerate(req):
            for d in range(len(id_lists[s])):
                pairs.append((r, d))
        pairs = np.asarray(pairs, np.int32)
        tm["pair_build_s"] = time.time() - t0
        t0 = time.time()
        # Fleet trees are scenario-leading with TIME-MAJOR edge storage
        # (S, H, n, N).  Gathering chain nodes on the MINOR axis reads
        # ~H*n strided singles per row.  Instead the chain columns are
        # contracted out with a per-scenario one-hot matmul at
        # Precision.HIGHEST (exact for f32), which streams the edge buffer
        # from device memory once.
        if getattr(self, "_gather_jits", None) is None:
            self._gather_jits = {}
        all_key = req == list(range(self.n_scenarios))
        gj = self._gather_jits.get((D, all_key))
        if gj is None:
            all_rows = all_key

            def gather(t, srow, ids_mat, si):
                Nn = t.edge_x.shape[-1]
                if all_rows:   # avoid a full-buffer identity gather (~3 GB)
                    ex, el, st = (t.edge_x,
                                  t.edge_len.astype(jnp.float32), t.state)
                else:
                    ex = t.edge_x[srow]                # (R, H, n, N) rows
                    el = t.edge_len[srow].astype(jnp.float32)
                    st = t.state[srow]
                R, Hh, nn_, _ = ex.shape
                oh = (ids_mat[:, :, None]
                      == jnp.arange(Nn)[None, None, :]).astype(jnp.float32)
                ex_g = jnp.einsum(
                    "rhnk,rdk->rdhn", ex, oh,
                    precision=jax.lax.Precision.HIGHEST)  # (R, D, H, n)
                len_g = jnp.einsum(
                    "rk,rdk->rd", el, oh,
                    precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
                ids_safe = jnp.maximum(ids_mat, 0)
                st_g = jnp.take_along_axis(st, ids_safe[:, :, None], axis=1)
                return (st_g[si[:, 0], si[:, 1]],
                        ex_g[si[:, 0], si[:, 1]],
                        len_g[si[:, 0], si[:, 1]])
            gj = jax.jit(gather)
            self._gather_jits[(D, all_key)] = gj
        states, edge_x, edge_len = (
            np.asarray(a) for a in jax.device_get(
                gj(self.trees, jnp.asarray(srow), jnp.asarray(ids_mat),
                   jnp.asarray(pairs))))
        tm["gather_transfer_s"] = time.time() - t0
        tm["transfer_bytes"] = int(states.nbytes + edge_x.nbytes
                                   + edge_len.nbytes)
        t0 = time.time()
        # Vectorized assembly: one boolean-mask flatten of all valid edge
        # steps (row order preserved), then per-scenario slices — the
        # per-edge python concatenate loop cost 0.21 s at 1024 scenarios.
        is_root = pairs[:, 1] == 0
        lens_eff = np.where(is_root, 0, edge_len).astype(np.int64)
        step_mask = (np.arange(edge_x.shape[1])[None, :]
                     < lens_eff[:, None])
        flat = edge_x[step_mask]                      # (total_steps, n)
        row_of = {}
        k = 0
        for r, s in enumerate(req):
            row_of[s] = k
            k += len(id_lists[s])
        csum = np.concatenate([[0], np.cumsum(lens_eff)])
        out = {}
        for s in req:
            k = row_of[s]
            a, b = csum[k], csum[k + len(id_lists[s])]
            out[s] = np.concatenate([states[k][None], flat[a:b]], 0)
        tm["host_assembly_s"] = time.time() - t0
        # where extraction time goes, for the fleet bench artifact
        #
        self.last_extract_timings = {k_: round(v, 4) for k_, v in tm.items()}
        return out

    def extract_plan(self, scenario: int):
        """Plan extraction for one scenario (see extract_plans)."""
        return self.extract_plans([scenario])[scenario]


def _tree_proto():
    """Structure-only TreeArrays pytree for sharding prefix maps."""
    return TreeArrays(*[0] * len(TreeArrays._fields))

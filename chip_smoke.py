"""Bring-up check of the planner on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: only the multi-device paths

One card, in order (every phase must pass, or the script exits non-zero):

1. device: JAX's device, and the card's name and power limit;
2. NN equivalence: each fused nearest-neighbour kernel
   (lqrrt_jax/ops/pallas/nn_kernel.py, compiled for the card) against the
   plain reference (core/nearest.py, float32 contractions at
   Precision.HIGHEST) at the boat's bench widths (B = 8192 candidates,
   N = 40960 rows, constant and per-node S) and the quadrotor's (n = 12,
   per-node S, B = 1024, N = 5120); the reference is anchored to an fp64
   brute force on 256 candidates;
3. the boat's main path: ``Planner`` at B = 8192, capacity 32768, warmed,
   then 3 replans of 1 s and 3 goal-biased replans; each must reach the goal
   with a collision-free plan;
4. the car and the quadrotor (per-node re-linearised LQR) at B = 1024,
   capacity 4096, one plan each;
5. 256 boat steer rollouts on the card against the fp64 numpy oracle.

With ``--chips 4`` it runs only the mesh planner (gather and topk
collectives, B = 8192, capacity 32768) and the 1024-scenario fleet on four
cards, each compared with the same run on one card.

The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed.  Needs an NVIDIA GPU: on any other
platform it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BOAT_SCALE = (40.0, 40.0, np.pi, 3.0, 3.0, 1.0)
_QUAD_SCALE = (10.0, 5.0, 2.0, 0.5, 0.5, np.pi, 2.0, 2.0, 1.0, 1.5, 1.5, 1.0)
NN_TOL = 5e-3          # relative cost excess (kernel vs ref, ref vs fp64)
STEER_TOL = 2e-3       # max |x_card - x_fp64| over rollout states, metres


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2: NN

def _nn_case(n, N, B, per_node, seed, scale):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    sc = jnp.asarray(scale[:n], jnp.float32)
    states = jax.random.uniform(ks[0], (N, n), minval=-1, maxval=1) * sc
    xrand = jax.random.uniform(ks[1], (B, n), minval=-1, maxval=1) * sc
    A = jax.random.normal(ks[2], (N if per_node else 1, n, n)) * 0.3
    S = A @ jnp.swapaxes(A, 1, 2) + 2.0 * jnp.eye(n)
    S = jnp.broadcast_to(S, (N, n, n)) if not per_node else S
    return states, S, xrand


def _cost64(st64, xr64, S64, ids, wrap_dim):
    e = xr64 - st64[ids]
    if wrap_dim is not None:
        e[:, wrap_dim] = np.mod(e[:, wrap_dim] + np.pi, 2 * np.pi) - np.pi
    return np.einsum("bi,bij,bj->b", e, S64[ids], e)


def _brute64(st64, xr64, S64, live, rows, wrap_dim, chunk=16):
    """True fp64 optimum over all live nodes for a candidate subsample."""
    out = []
    for i in range(0, len(rows), chunk):
        e = xr64[rows[i:i + chunk], None, :] - st64[None, :live, :]
        if wrap_dim is not None:
            e[..., wrap_dim] = np.mod(e[..., wrap_dim] + np.pi,
                                      2 * np.pi) - np.pi
        q = np.einsum("nij,bnj->bni", S64[:live], e)
        out.append(np.sum(e * q, axis=-1).min(axis=1))
    return np.concatenate(out)


def _time(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_nn(cases=None, interpret=False):
    """Each kernel form vs the plain reference; returns {case: record}."""
    import jax
    import jax.numpy as jnp
    from lqrrt_jax.core.nearest import make_nearest
    from lqrrt_jax.ops.angles import make_erf
    from lqrrt_jax.ops.pallas.nn_kernel import make_nearest_pallas

    if cases is None:
        cases = [("boat_const", 6, 40960, 8192, 2, False, _BOAT_SCALE),
                 ("boat_per_node", 6, 40960, 8192, 2, True, _BOAT_SCALE),
                 ("quad_per_node", 12, 5120, 1024, 5, True, _QUAD_SCALE)]
    out = {}
    for i, (name, n, N, B, wd, per_node, scale) in enumerate(cases):
        states, S, xrand = _nn_case(n, N, B, per_node, 3 + i, scale)
        size = jnp.asarray(N - 173, jnp.int32)
        ref = jax.jit(make_nearest(make_erf(n, angle_dims=(wd,)),
                                   block=min(1024, N)))
        ker = jax.jit(make_nearest_pallas(wrap_dim=wd,
                                          const_metric=not per_node,
                                          interpret=interpret))
        ids_r, _ = jax.device_get(ref(states, S, size, xrand))
        ids_k, _ = jax.device_get(ker(states, S, size, xrand))
        st64 = np.asarray(states, np.float64)
        xr64 = np.asarray(xrand, np.float64)
        S64 = np.asarray(S, np.float64)
        c_r = _cost64(st64, xr64, S64, ids_r, wd)
        c_k = _cost64(st64, xr64, S64, ids_k, wd)
        worst = float(np.max((c_k - c_r) / np.maximum(np.abs(c_r), 1e-6)))
        rows = np.arange(0, B, max(B // 256, 1))[:256]
        c_star = _brute64(st64, xr64, S64, int(size), rows, wd)
        ref_excess = float(np.max((c_r[rows] - c_star)
                                  / np.maximum(np.abs(c_star), 1e-6)))
        rec = dict(id_match=float(np.mean(ids_r == ids_k)),
                   worst_rel_excess=worst, ref_vs_fp64_excess=ref_excess)
        if not interpret:
            rec["kernel_ms"] = 1e3 * _time(ker, states, S, size, xrand)
            rec["xla_ms"] = 1e3 * _time(ref, states, S, size, xrand)
        print(f"nn [{name}] n={n} N={N} B={B} size={int(size)}: "
              + ", ".join(f"{k}={v:.6g}" for k, v in rec.items()),
              flush=True)
        check(worst <= NN_TOL, f"nn [{name}]: kernel excess {worst:.3g}")
        check(ref_excess <= NN_TOL,
              f"nn [{name}]: reference excess over fp64 {ref_excess:.3g}")
        out[name] = rec
    return out


# ---------------------------------------------------------- plan checking

def check_plan(name, prob, planner, margin):
    """Goal reached, plan ends inside the goal box, and every plan state
    clears every circle by the model's feasibility margin."""
    x = np.asarray(planner.x_seq, np.float64)
    check(planner.plan_reached_goal, f"{name}: goal not reached")
    e = np.asarray(prob["goal"], np.float64) - x[-1]
    wd = prob.get("wrap_dims", ())
    for d in wd:
        e[d] = np.mod(e[d] + np.pi, 2 * np.pi) - np.pi
    gbuf = np.asarray(prob["constraints"].goal_buffer, np.float64)
    check(np.all(np.abs(e) <= gbuf + 1e-4),
          f"{name}: plan ends outside the goal box (|e| = {np.abs(e)})")
    centers, radii = (np.asarray(a, np.float64) for a in prob["obstacles"])
    d = np.linalg.norm(x[:, None, :2] - centers[None], axis=-1) - radii
    clear = float(d.min()) if d.size else np.inf
    check(clear >= margin - 1e-3,
          f"{name}: plan clearance {clear:.4f} m below margin {margin} m")
    return clear


def _planner(prob, **kw):
    import lqrrt_jax
    return lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, wrap_dims=prob["wrap_dims"],
        saturate=prob["saturate"], **kw)


# ---------------------------------------------------------- phase 3: boat

def phase_boat(card, expect_nn, batch=8192, capacity=32768, budget=1.0):
    import jax
    from lqrrt_jax.models import boat

    prob = boat.default_problem()
    planner = _planner(prob, batch_size=batch, capacity=capacity, seed=0)
    t0 = time.perf_counter()
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.0,
                   pruning=True)
    setup_s = time.perf_counter() - t0
    check(planner.nn_selected == expect_nn,
          f"boat: nn_selected {planner.nn_selected!r} != {expect_nn!r}")
    eps = []
    for r in range(3):
        planner._key = jax.random.PRNGKey(100 + r)
        planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.0,
                            specific_time=budget, pruning=False)
        eps.append(planner.stats["expansions_per_s"])
        check_plan(f"boat budget run {r}", prob, planner, margin=1.0)
    lats, durs = [], []
    for r in range(3):
        planner._key = jax.random.PRNGKey(200 + r)
        t0 = time.perf_counter()
        planner.update_plan(prob["x0"], prob["sample_space"],
                            goal_bias=[0.3, 0.3, 0, 0, 0, 0])
        lats.append(time.perf_counter() - t0)
        durs.append(float(planner.T))
        check_plan(f"boat goal-biased run {r}", prob, planner, margin=1.0)
    rec = dict(expansions_per_s=float(np.median(eps)),
               p50_replan_s=float(np.median(lats)),
               plan_duration_s=float(np.median(durs)),
               warmup_compile_s=setup_s, nn=planner.nn_selected)
    print(f"boat B={batch} capacity={capacity}: "
          f"{rec['expansions_per_s']:.1f} expansions/s (median of 3 x "
          f"{budget} s), p50 replan {rec['p50_replan_s']:.4f} s, plan "
          f"{rec['plan_duration_s']:.2f} s, warmup {setup_s:.1f} s, "
          f"nn={rec['nn']} on {card}", flush=True)
    return rec


# ------------------------------------------------ phase 4: car, quadrotor

def phase_models(card, expect_nn, batch=1024, capacity=4096, budget=1.0):
    import jax
    from lqrrt_jax.models import car, quadrotor

    out = {}
    for name, mod, bias, margin in (
            ("car", car, [0.3, 0.3, 0, 0], 0.5),
            ("quadrotor", quadrotor, [0.3, 0.3, 0.3] + [0.0] * 9, 0.3)):
        prob = mod.default_problem()
        planner = _planner(prob, batch_size=batch, capacity=capacity, seed=7)
        planner.warmup(prob["x0"], prob["sample_space"], goal_bias=bias,
                       pruning=False)
        check(planner.nn_selected == expect_nn,
              f"{name}: nn_selected {planner.nn_selected!r} != "
              f"{expect_nn!r}")
        planner._key = jax.random.PRNGKey(7)
        planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=bias,
                            specific_time=budget, pruning=False)
        clear = check_plan(name, prob, planner, margin)
        out[name] = dict(expansions_per_s=planner.stats["expansions_per_s"],
                         plan_duration_s=float(planner.T))
        print(f"{name} B={batch} capacity={capacity}: "
              f"{out[name]['expansions_per_s']:.1f} expansions/s, plan "
              f"{planner.T:.2f} s, clearance {clear:.3f} m, "
              f"nn={planner.nn_selected} on {card}", flush=True)
    return out


# ------------------------------------------------- phase 5: steer/oracle

def phase_steer(n_cand=256, seed=5):
    import jax
    import jax.numpy as jnp
    from lqrrt_jax.core.steer import make_steer
    from lqrrt_jax.models import boat
    from lqrrt_jax.oracle import numpy_planner as oracle

    prob = boat.default_problem()
    S, K = (np.asarray(a, np.float64) for a in prob["lqr"](None, None))
    rng = np.random.default_rng(seed)
    space = np.asarray(prob["sample_space"], np.float64)
    x0 = rng.uniform(space[:, 0], space[:, 1], (n_cand, 6))
    x0[:, :2] = rng.uniform([-2, -10], [44, 10], (n_cand, 2))
    xtar = x0 + rng.normal(0, [3, 3, 0.5, 0.5, 0.2, 0.2], (n_cand, 6))
    steer = jax.jit(make_steer(
        prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
        100, prob["dt"], 0.05, saturate=prob["saturate"]))
    Kb = jnp.broadcast_to(jnp.asarray(K, jnp.float32), (n_cand,) + K.shape)
    res = jax.device_get(steer(jnp.asarray(x0, jnp.float32), Kb,
                               jnp.asarray(xtar, jnp.float32)))
    dyn_np, sat_np = oracle.boat_dynamics_factory()
    orc = oracle.NumpyOracle(
        dynamics=dyn_np, lqr=lambda x, u: (S, K), erf=oracle.boat_erf,
        is_feasible=oracle.make_circle_feasibility(*prob["obstacles"],
                                                   margin=1.0),
        goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], saturate=sat_np)
    worst, len_mismatch = 0.0, 0
    for b in range(n_cand):
        xs, _, _ = orc._steer(x0[b], K, xtar[b])
        L = min(len(xs), int(res.length[b]))
        len_mismatch += int(len(xs) != int(res.length[b]))
        if L:
            d = np.abs(np.asarray(res.x_seq[b][:L], np.float64) - xs[:L])
            d[:, 2] = np.abs(np.mod(d[:, 2] + np.pi, 2 * np.pi) - np.pi)
            worst = max(worst, float(d.max()))
    print(f"steer vs fp64 oracle ({n_cand} boat rollouts, H=100): max state "
          f"error {worst:.3g} (tolerance {STEER_TOL}), rollout-length "
          f"mismatches {len_mismatch}/{n_cand}", flush=True)
    check(worst <= STEER_TOL, f"steer: max state error {worst:.3g}")
    check(len_mismatch <= n_cand // 100,
          f"steer: {len_mismatch} rollout lengths differ from the oracle")
    return dict(max_state_error=worst, length_mismatches=len_mismatch)


# -------------------------------------------------- --chips 4: the mesh

def _fixed_chunk_clock(n_chunks):
    """sys_time stub allowing exactly n_chunks chunk dispatches."""
    state = {"n": 0}

    def clock():
        state["n"] += 1
        return 0.0 if state["n"] <= n_chunks + 1 else 1e9
    return clock


def _mem_line(devs):
    used = [(d.memory_stats() or {}).get("bytes_in_use", 0) / 2**20
            for d in devs]
    return ", ".join(f"{d.id}: {u:.0f} MiB" for d, u in zip(devs, used)), used


def phase_mesh(n_dev, batch=8192, capacity=32768, n_scen=1024,
               fleet_batch=64, fleet_cap=1024, fleet_rounds=16,
               interpret=False):
    """Mesh planner (gather, topk) and the fleet on n_dev devices, each
    compared with the same computation on one device."""
    import jax
    import jax.numpy as jnp
    from lqrrt_jax.core.rounds import (RoundSpec, commit_candidates,
                                       make_expand)
    from lqrrt_jax.core.sampling import normalize_goal_bias, sample_batch
    from lqrrt_jax.core.tree import init_tree
    from lqrrt_jax.models import boat
    from lqrrt_jax.ops.pallas.nn_kernel import make_nearest_pallas
    from lqrrt_jax.parallel import mesh as meshlib
    from lqrrt_jax.parallel.fleet import FleetPlanner
    from lqrrt_jax.parallel.sharded import (candidate_scores,
                                            make_sharded_round,
                                            replicate_tree)

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, have {len(devs)}")
    prob = boat.default_problem()
    space = jnp.asarray(prob["sample_space"], jnp.float32)
    goal = jnp.asarray(prob["goal"], jnp.float32)
    gb = normalize_goal_bias([0.3, 0.3, 0, 0, 0, 0], 6)
    mesh = meshlib.make_mesh(n_dev)
    out = {}

    # (1) gather: one fused restart cycle, mesh vs one device fed the same
    # per-device sample folds
    def emulate(k, B):
        return jnp.concatenate([sample_batch(jax.random.fold_in(k, d),
                                             B // n_dev, space, gb, goal)
                                for d in range(n_dev)], 0)

    runs = {}
    for tag, kw in (("mesh", dict(mesh=mesh)), ("one", {})):
        p = _planner(prob, batch_size=batch, capacity=capacity, seed=11,
                     rounds_per_chunk=-(-(capacity - 1) // batch),
                     informed=0.0, **kw)
        p.sys_time = _fixed_chunk_clock(1)
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=gb,
                      pruning=False, specific_time=1.0,
                      xrand_gen=None if tag == "mesh" else emulate)
        if tag == "mesh":
            line, used = _mem_line(devs)
            print(f"mesh gather: memory in use per device: {line}",
                  flush=True)
            check(min(used) >= 0.5 * max(used),
                  "mesh gather: devices do not hold equal shares")
        runs[tag] = p
    tm, t1 = runs["mesh"]._device_tree, runs["one"]._device_tree
    size = int(t1.size)
    par_m = np.asarray(tm.parent)[:size]
    par_1 = np.asarray(t1.parent)[:size]
    st_err = float(np.max(np.abs(np.asarray(tm.state)[:size]
                                 - np.asarray(t1.state)[:size])))
    parent_match = float(np.mean(par_m == par_1))
    print(f"mesh gather B={batch} capacity={capacity} on {n_dev} devices vs "
          f"1: size {int(tm.size)} vs {size}, parent match {parent_match}, "
          f"max state diff {st_err:.3g}, goal {runs['mesh'].plan_reached_goal}"
          f"/{runs['one'].plan_reached_goal}", flush=True)
    check(int(tm.size) == size, "mesh gather: tree sizes differ")
    check(parent_match >= 0.999, "mesh gather: parents differ")
    check(st_err <= 1e-3, "mesh gather: states differ")
    out["gather"] = dict(parent_match=parent_match, max_state_diff=st_err)

    # (2) topk: the sharded round vs one device committing the identical
    # global top-k (tests/test_sharded.py at bench widths)
    H = int(round(prob["horizon"] / prob["dt"]))
    slack = -(-batch // 1024) * 1024
    spec = RoundSpec(nstates=6, ncontrols=3, batch=batch, horizon_steps=H,
                     capacity=capacity, dt=prob["dt"], slack=slack,
                     commit_all=True)
    K = batch // 8
    feas = prob["constraints"].is_feasible
    gbuf = prob["constraints"].goal_buffer
    wrap = np.zeros(6, bool)
    wrap[2] = True
    common = dict(wrap_mask=wrap, saturate=prob["saturate"],
                  nearest_fn=make_nearest_pallas(const_metric=True,
                                                 interpret=interpret))
    S0, K0 = prob["lqr"](None, None)

    def tree0():
        return init_tree(capacity, H, 6, 3, jnp.asarray(prob["x0"]), S0, K0,
                         1e9, False, slack=slack)
    rf_sh = jax.jit(make_sharded_round(
        spec, mesh, prob["dynamics"], prob["lqr"], jnp.subtract, feas, 0.05,
        gbuf, collective="topk", topk=K, **common), donate_argnums=(0,))
    expand = make_expand(spec, prob["dynamics"], prob["lqr"], jnp.subtract,
                         feas, 0.05, gbuf, **common)

    @jax.jit
    def one_chip(tree, xrand):
        c = expand(tree, xrand, goal)
        score = candidate_scores(tree, c, spec.dt)
        _, gidx = jax.lax.top_k(-score, K)
        w = c._replace(**{f: (getattr(c, f)[..., gidx]
                              if f in ("x_seq", "u_seq")
                              else getattr(c, f)[gidx]) for f in c._fields})
        w = w._replace(length=jnp.where(jnp.take(score, gidx) < jnp.inf,
                                        w.length, 0))
        return commit_candidates(spec, tree, w)

    key = jax.random.PRNGKey(9)
    t_sh = replicate_tree(tree0(), mesh)     # donated by rf_sh
    t_1 = tree0()
    for r in range(3):
        k = jax.random.fold_in(key, r)
        t_sh = rf_sh(t_sh, k, goal, space, gb, goal)
        t_1 = one_chip(t_1, emulate(k, batch))
    line, used = _mem_line(devs)
    print(f"mesh topk: memory in use per device: {line}", flush=True)
    size = int(t_1.size)
    match = {f: float(np.mean(np.asarray(getattr(t_sh, f))[:size]
                              == np.asarray(getattr(t_1, f))[:size]))
             for f in ("parent", "edge_len", "in_goal")}
    st_err = float(np.max(np.abs(np.asarray(t_sh.state)[:size]
                                 - np.asarray(t_1.state)[:size])))
    print(f"mesh topk k={K} B={batch} capacity={capacity}, 3 rounds on "
          f"{n_dev} devices vs 1: size {int(t_sh.size)} vs {size}, field "
          f"match {match}, max state diff {st_err:.3g}", flush=True)
    check(int(t_sh.size) == size, "mesh topk: tree sizes differ")
    check(min(match.values()) >= 0.999, "mesh topk: trees differ")
    check(st_err <= 1e-3, "mesh topk: states differ")
    out["topk"] = dict(field_match=match, max_state_diff=st_err)

    # (3) fleet: n_scen scenarios sharded over the devices vs one device
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(prob["x0"]), (n_scen, 1))
    goals = np.tile(np.asarray(prob["goal"]), (n_scen, 1))
    goals[:, 0] += rng.uniform(-4, 4, n_scen)
    goals[:, 1] += rng.uniform(-6, 6, n_scen)
    fl = {}
    for tag, m in (("mesh", meshlib.make_fleet_mesh(n_dev)), ("one", None)):
        fleet = FleetPlanner(
            prob["dynamics"], prob["lqr"], prob["erf"], feas, gbuf,
            horizon=prob["horizon"], dt=prob["dt"], n_scenarios=n_scen,
            batch_size=fleet_batch, capacity=fleet_cap, nn_block=256,
            saturate=prob["saturate"], wrap_dims=prob["wrap_dims"], mesh=m,
            seed=1)
        fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                   rounds=1)                                # compile
        t0 = time.perf_counter()
        st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                        rounds=fleet_rounds)
        wall = time.perf_counter() - t0
        if tag == "mesh":
            line, used = _mem_line(devs)
            print(f"fleet: memory in use per device: {line}", flush=True)
            check(min(used) >= 0.5 * max(used),
                  "fleet: devices do not hold equal shares")
        fl[tag] = (st, np.asarray(fleet.trees.parent), wall)
    (st_m, par_m, w_m), (st_1, par_1, w_1) = fl["mesh"], fl["one"]
    same_size = float(np.mean(st_m["sizes"] == st_1["sizes"]))
    same_goal = float(np.mean(st_m["goal_found"] == st_1["goal_found"]))
    par_match = float(np.mean(par_m == par_1))
    print(f"fleet {n_scen} scenarios, batch {fleet_batch}, capacity "
          f"{fleet_cap}, {fleet_rounds} rounds on {n_dev} devices vs 1: "
          f"wall {w_m:.3f} s vs {w_1:.3f} s, goal rate "
          f"{st_m['goal_found'].mean():.4f}, per-scenario size match "
          f"{same_size}, goal match {same_goal}, parent match {par_match}",
          flush=True)
    check(same_size >= 0.999 and same_goal >= 0.999 and par_match >= 0.999,
          "fleet: sharded scenarios differ from the one-device run")
    out["fleet"] = dict(wall_s_mesh=w_m, wall_s_one=w_1,
                        size_match=same_size, parent_match=par_match)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device paths on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, _HERE)
    try:
        import lqrrt_jax  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lqrrt_jax package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    import jax
    from lqrrt_jax.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {devs[0].platform}"
              f" devices {devs}", file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees {len(devs)} "
              f"devices", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        card = card_line()
        print(f"device: {devs} kind={devs[0].device_kind} "
              f"count={len(devs)} card: {card}", flush=True)
        if args.chips == 4:
            phase_mesh(4)
        else:
            phase_nn()
            phase_boat(card, "pallas_const")
            phase_models(card, "pallas")
            phase_steer()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

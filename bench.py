"""Benchmark: boat-demo tree expansions/s on one GPU vs the single-CPU numpy
oracle.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

metric definition (BASELINE.json): tree expansions/s/chip on the Navigator
WAM-V boat demo under the ~1 s replan budget.  The reference publishes no
numbers (SURVEY.md section 6), so the baseline is the numpy oracle — a
faithful sequential re-implementation of the reference algorithm — measured
on one CPU core in this same run.  vs_baseline = GPU expansions/s / oracle
expansions/s.  Needs an NVIDIA GPU: on any other platform it exits
non-zero; the JSON line names the card and its power limit.

Extra fields in the same JSON line (the on-device NN kernel equivalence
lives in chip_smoke.py):
  plan_duration_s_*     boat plan quality at 0.2 s vs 1.0 s anytime budgets
  refine_quality_ok     true iff the 1.0 s plan is STRICTLY shorter than the
                        0.2 s plan (anytime restarts must buy quality)
  quality_*             oracle-vs-planner plan-quality ratios for boat, car and
                        quadrotor, averaged over seeds (golden parity,
                        SURVEY.md section 4 item 2)

Extra diagnostics (p50 replan latency, goal rate) go to stderr.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_oracle(prob, budget_s=3.0):
    from lqrrt_jax.oracle import numpy_planner as oracle
    import scipy.linalg  # noqa: F401  (oracle lqr built from jax model below)
    import jax

    dyn_np, sat_np = oracle.boat_dynamics_factory()
    S, K = prob["lqr"](None, None)
    S = np.asarray(jax.device_get(S), np.float64)
    K = np.asarray(jax.device_get(K), np.float64)
    feas = oracle.make_circle_feasibility(*prob["obstacles"], margin=1.0)
    orc = oracle.NumpyOracle(
        dynamics=dyn_np, lqr=lambda x, u: (S, K), erf=oracle.boat_erf,
        is_feasible=feas, goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], saturate=sat_np)
    reached, stats, _ = orc.plan(
        prob["x0"], prob["goal"], prob["sample_space"], goal_bias=0.2,
        seed=0, min_time=budget_s, max_time=budget_s)
    log(f"oracle (1 CPU core, sequential reference semantics): "
        f"{stats['expansions_per_s']:.0f} expansions/s, "
        f"nodes={stats['nodes']}, goal={reached}")
    return stats["expansions_per_s"]


def bench_planner(prob, budget_s=1.0, batch=8192, capacity=32768, repeats=3):
    import lqrrt_jax

    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=batch, capacity=capacity,
        wrap_dims=prob["wrap_dims"], saturate=prob["saturate"], seed=0)
    # warm EVERY dispatchable program (compile excluded from the timed
    # budget): grow chunk, restart-stash score, extraction, and the
    # shortcut-steer batch — so no variant compiles inside a timed run
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.0,
                   pruning=True)
    eps, lats, goals = [], [], 0
    for r in range(repeats):
        planner._key = __import__("jax").random.PRNGKey(100 + r)
        t0 = time.time()
        reached = planner.update_plan(
            prob["x0"], prob["sample_space"], goal_bias=0.0,
            specific_time=budget_s, pruning=False)
        lats.append(time.time() - t0)
        eps.append(planner.stats["expansions_per_s"])
        goals += int(reached)
        log(f"  planner run {r}: "
            f"{planner.stats['expansions_per_s']:.0f} exp/s, "
            f"{planner.stats['rounds']} rounds, nodes={planner.stats['nodes']}, "
            f"goal={reached}")
    # p50 replan latency with the anytime goal-biased configuration
    glats = []
    for r in range(repeats):
        planner._key = __import__("jax").random.PRNGKey(200 + r)
        t0 = time.time()
        planner.update_plan(prob["x0"], prob["sample_space"],
                            goal_bias=[0.3, 0.3, 0, 0, 0, 0])
        glats.append(time.time() - t0)
    log(f"planner p50 replan latency (goal-biased, [0.5,1]s budget): "
        f"{np.median(glats):.3f}s")

    # plan quality vs anytime budget: anytime restarts (stash best tree,
    # reseed with chain planting, keep growing) must keep buying quality —
    # the 1.0 s plans must be strictly shorter than the 0.2 s plans ON
    # AVERAGE over fixed seeds.
    # 3-seed means — the flagship instance saturates within ~1% of its
    # 16.75 s floor, so a single-seed strict
    # comparison flips sign on noise once a 0.2 s run lands on the floor.
    durs = {}
    for budget in (0.2, 1.0):
        vals = []
        for seed in (777, 101, 202):
            planner._key = __import__("jax").random.PRNGKey(seed)
            planner.update_plan(prob["x0"], prob["sample_space"],
                                goal_bias=[0.3, 0.3, 0, 0, 0, 0],
                                specific_time=budget, pruning=True)
            vals.append(float(planner.T))
        durs[budget] = round(float(np.mean(vals)), 3)
        log(f"  plan quality: budget {budget}s -> durations {vals} "
            f"(mean {durs[budget]:.2f}s)")
    return float(np.median(eps)), float(np.median(glats)), durs


def _oracle_problem(name, goal_entry_trunc=False):
    """(oracle planner, jax problem dict, per-dim goal bias) for a model.

    ``goal_entry_trunc=True`` gives the oracle the same first-entry goal
    truncation the planner uses, so quality ratios compare planners and
    not dt resolution."""
    from lqrrt_jax.oracle import numpy_planner as oracle

    if name == "boat":
        from lqrrt_jax.models import boat as model
        import jax
        prob = model.default_problem()
        dyn_np, sat_np = oracle.boat_dynamics_factory()
        S, K = prob["lqr"](None, None)
        S = np.asarray(jax.device_get(S), np.float64)
        K = np.asarray(jax.device_get(K), np.float64)
        lqr_np = lambda x, u: (S, K)  # noqa: E731
        erf_np = oracle.boat_erf
        margin = 1.0
        bias = [0.3, 0.3, 0, 0, 0, 0]
    elif name == "car":
        from lqrrt_jax.models import car as model
        prob = model.default_problem()
        dyn_np, sat_np, f_np = oracle.car_dynamics_factory()

        def x_map(x):
            v = x[3]
            x = x.copy()
            x[3] = (-0.8 if v < 0 else 0.8) if abs(v) < 0.8 else v
            return x

        lqr_np = oracle.make_scipy_relinearized_lqr(
            f_np, np.diag([1.0, 1.0, 0.5, 0.3]), np.diag([0.5, 2.0]),
            u_eq=np.zeros(2), x_map=x_map)
        erf_np = oracle.make_erf_np(angle_dims=(2,))
        margin = 0.5
        bias = [0.3, 0.3, 0, 0]
    elif name == "quadrotor":
        from lqrrt_jax.models import quadrotor as model
        prob = model.default_problem()
        dyn_np, sat_np, f_np = oracle.quadrotor_dynamics_factory()
        lqr_np = oracle.make_scipy_relinearized_lqr(
            f_np,
            np.diag([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 0.3, 0.3, 0.3,
                     0.1, 0.1, 0.1]),
            np.diag([0.02, 2.0, 2.0, 2.0]), u_eq=np.zeros(4))
        erf_np = oracle.make_erf_np(angle_dims=(5,))
        margin = 0.3
        bias = [0.3, 0.3, 0.3] + [0.0] * 9
    else:
        raise ValueError(name)
    feas = oracle.make_circle_feasibility(*prob["obstacles"], margin=margin)
    orc = oracle.NumpyOracle(
        dynamics=dyn_np, lqr=lqr_np, erf=erf_np, is_feasible=feas,
        goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], saturate=sat_np,
        goal_entry_trunc=goal_entry_trunc)
    return orc, prob, np.asarray(bias, np.float64)


def bench_quality(names=("boat", "car", "quadrotor"), budget=1.0):
    """Oracle-vs-planner plan quality over multiple seeds (golden parity,
    SURVEY.md section 4 item 2).  Ratio = planner plan
    duration / oracle plan duration; both planners get the same problem,
    same per-dim goal bias, disjoint solver stacks end to end.  Reported:
    per-seed ratios + mean + spread, so the headline numbers carry their
    variance.

    Apples-to-apples: the oracle runs with the SAME
    first-entry goal truncation the planner uses (goal_entry_trunc=True)
    so the ratio no longer includes the planner side's free dt resolution.
    """
    import lqrrt_jax

    # Oracle budgets: the sequential reference needs far longer than the
    # planner to reach the goal at all.  The nonholonomic car gets 30 s and
    # seeds verified to give it a fighting chance (at 20 s / seed 7 it never
    # reached the goal, leaving the ratio unmeasured).  Budgets sized so the oracle reaches the goal on most seeds even
    # when the host is having a slow session (oracle nodes/s varies ~2x run
    # to run; a too-tight budget collapses the measurable-ratio count).
    oracle_budget = {"boat": 8.0, "car": 24.0, "quadrotor": 24.0}
    seeds_10 = (7, 11, 23, 31, 47, 5, 13, 17, 29, 41)
    seeds = {"boat": seeds_10, "car": seeds_10, "quadrotor": seeds_10}
    out = {}
    for name in names:
        orc, prob, bias = _oracle_problem(name, goal_entry_trunc=True)
        ob = oracle_budget.get(name, 6.0)
        planner = lqrrt_jax.Planner(
            prob["dynamics"], prob["lqr"], prob["constraints"],
            horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
            printing=False, batch_size=1024, capacity=4096,
            wrap_dims=prob["wrap_dims"], saturate=prob["saturate"], seed=7)
        planner.warmup(prob["x0"], prob["sample_space"],
                       goal_bias=list(bias), pruning=False)  # untimed
        ratios, go, gt = [], 0, 0
        for seed in seeds.get(name, (7,)):
            reached_o, stats_o, _ = orc.plan(
                prob["x0"], prob["goal"], prob["sample_space"],
                goal_bias=bias, seed=seed, min_time=ob, max_time=ob)
            planner._key = __import__("jax").random.PRNGKey(seed)
            # pruning off: the oracle extracts its raw best branch, so the
            # fair duration comparison is the unsmoothed planner branch
            reached_t = planner.update_plan(
                prob["x0"], prob["sample_space"], goal_bias=list(bias),
                specific_time=budget, pruning=False)
            dur_o = float(stats_o["plan_duration_s"])
            dur_t = float(planner.T)
            go += int(reached_o)
            gt += int(reached_t)
            ratio = (round(dur_t / dur_o, 3) if reached_o and reached_t
                     and dur_o > 0 else None)
            if ratio is not None:
                ratios.append(ratio)
            log(f"quality [{name}] seed {seed}: oracle {dur_o:.2f}s "
                f"(goal={reached_o}, {stats_o['nodes']} nodes in {ob}s) vs "
                f"planner {dur_t:.2f}s (goal={reached_t}) -> ratio={ratio}")
        n = len(seeds.get(name, (7,)))
        out[f"quality_{name}_goal_oracle"] = f"{go}/{n}"
        out[f"quality_{name}_goal_planner"] = f"{gt}/{n}"
        out[f"quality_{name}_duration_ratio"] = (
            round(float(np.mean(ratios)), 3) if ratios else None)
        out[f"quality_{name}_duration_ratio_seeds"] = ratios
        out[f"quality_{name}_duration_ratio_spread"] = (
            [round(float(np.min(ratios)), 3), round(float(np.max(ratios)), 3)]
            if ratios else None)
        log(f"quality [{name}]: mean ratio "
            f"{out[f'quality_{name}_duration_ratio']} over {len(ratios)} "
            f"measurable seeds, spread "
            f"{out[f'quality_{name}_duration_ratio_spread']} "
            f"(oracle goal {go}/{n}, planner goal {gt}/{n})")
    return out


def main():
    import jax
    from lqrrt_jax.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py needs an NVIDIA GPU; JAX found {jax.devices()}")
        return 1
    from chip_smoke import card_line
    card = card_line()
    log(f"device: {dev} ({dev.device_kind}), card: {card}")
    from lqrrt_jax.models import boat
    t0 = time.time()
    prob = boat.default_problem()
    log(f"problem setup: {time.time()-t0:.1f}s")

    oracle_eps = bench_oracle(prob)
    eps, p50, durs = bench_planner(prob)
    extra = {"plan_duration_s_budget_0p2": round(durs[0.2], 3),
             "plan_duration_s_budget_1p0": round(durs[1.0], 3),
             # explicit pass/fail so a refinement regression cannot hide in
             # identical durations
             "refine_quality_ok": bool(durs[1.0] < durs[0.2] - 1e-3)}
    log(f"refine quality gate (1.0s strictly shorter than 0.2s): "
        f"{extra['refine_quality_ok']}")
    extra.update(bench_quality())

    print(json.dumps({
        "metric": "boat_tree_expansions_per_s",
        "value": round(eps, 1),
        "unit": "expansions/s",
        "vs_baseline": round(eps / max(oracle_eps, 1e-9), 2),
        "baseline_cpu_expansions_per_s": round(oracle_eps, 1),
        "p50_replan_latency_s": round(p50, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count(), "card": card},
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

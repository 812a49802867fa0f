"""Fleet benchmark at advertised scale (BASELINE.json config 5: fleet
replanning, 1k simultaneous boat scenarios).

Runs the scenario-parallel FleetPlanner (P4, lqrrt_jax/parallel/fleet.py) at
--scenarios boat problems on the current backend, under a wall-clock anytime
budget, and writes a JSON artifact with aggregate expansions/s, goal rate,
and time-to-first-goal stats.

Memory note: per-scenario device memory is dominated by edge rollout storage,
(capacity + slack) x horizon_steps x (n + m) x 4 B -- at the defaults
(capacity 1024, nn_block 256 -> slack 256, H=100, n+m=9) that is ~4.6 MiB per
scenario, ~4.7 GiB for 1024 scenarios: fits one GPU.  Scenarios shard over
every visible device.  Needs a GPU.

Run:  python tools/bench_fleet.py [--scenarios 1024] [--out fleet.json]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from lqrrt_jax.models import boat  # noqa: E402
from lqrrt_jax.parallel import mesh as meshlib  # noqa: E402
from lqrrt_jax.parallel.fleet import FleetPlanner  # noqa: E402
from lqrrt_jax.utils.cache import enable_persistent_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--max-time", type=float, default=2.0,
                    help="wall-clock anytime budget (s)")
    ap.add_argument("--out", default=None, help="JSON artifact path")
    args = ap.parse_args()

    enable_persistent_cache()
    n_dev = jax.device_count()
    if jax.devices()[0].platform != "gpu":
        print(f"bench_fleet.py needs a GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        return 1
    S = args.scenarios - args.scenarios % n_dev or n_dev
    dev = jax.devices()[0]
    print(f"device: {dev} x{n_dev}, scenarios: {S}")

    prob = boat.default_problem()
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
        batch_size=args.batch, capacity=args.capacity, nn_block=256,
        saturate=prob["saturate"], wrap_dims=prob["wrap_dims"],
        mesh=meshlib.make_fleet_mesh(n_dev))

    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    goals[:, 0] += rng.uniform(-4, 4, S)
    goals[:, 1] += rng.uniform(-6, 6, S)

    # warm-up compile (one chunk), then the timed anytime run
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=1,
               max_time=1e9, rounds_per_chunk=1)
    t0 = time.time()
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                       rounds=args.rounds, max_time=args.max_time,
                       rounds_per_chunk=8)
    wall = time.time() - t0

    # batched extraction of EVERY scenario's plan: one vmapped chain walk +
    # one flat gather + one transfer
    t1 = time.time()
    plans = fleet.extract_plans()
    extract_cold = time.time() - t1
    # warm best-of-3: the cold call pays jit compiles; steady-state
    # replanning re-extracts every cycle, so the warm best-of-N is the
    # operating cost
    extract_wall = float("inf")
    best_tm = None
    for _ in range(3):
        t1 = time.time()
        plans = fleet.extract_plans()
        dt_e = time.time() - t1
        if dt_e < extract_wall:
            extract_wall = dt_e
            best_tm = dict(fleet.last_extract_timings)
    fleet.last_extract_timings = best_tm

    gt = stats["goal_time_s"][~np.isnan(stats["goal_time_s"])]
    rec = {
        "metric": "fleet_boat_expansions_per_s_aggregate",
        "value": round(stats["expansions_per_s"], 1),
        "unit": "expansions/s",
        "scenarios": int(S),
        "rounds": int(stats["rounds"]),
        "budget_s": args.max_time,
        "wall_s": round(wall, 3),
        "budget_overshoot_pct": round(100.0 * max(
            wall / args.max_time - 1.0, 0.0), 1),
        "goal_rate": round(float(stats["goal_found"].mean()), 4),
        "mean_nodes": round(float(stats["sizes"].mean()), 1),
        "goal_time_p50_s": round(float(np.median(gt)), 3) if len(gt) else None,
        "goal_time_p99_s": (round(float(np.percentile(gt, 99)), 3)
                            if len(gt) else None),
        "extract_all_plans_s": round(extract_wall, 3),
        "extract_all_plans_cold_s": round(extract_cold, 3),
        "extract_breakdown": getattr(fleet, "last_extract_timings", None),
        "mean_plan_steps": round(float(np.mean(
            [len(p) for p in plans.values()])), 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
    }
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return 0 if rec["goal_rate"] > 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())

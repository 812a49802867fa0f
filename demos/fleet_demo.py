"""P4: fleet replanning — many simultaneous boat scenarios, scenario axis
sharded over the device mesh (BASELINE.json config 5: 1k simultaneous
boat scenarios).

On one GPU this runs the vmapped fleet on a 1-device mesh; on several the
same code shards scenarios across all devices (see
lqrrt_jax/parallel/fleet.py and tests/test_sharded.py for the 8-virtual-device
version).

Run:  python demos/fleet_demo.py [--scenarios 64] [--rounds 8]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from lqrrt_jax.models import boat  # noqa: E402
from lqrrt_jax.parallel import mesh as meshlib  # noqa: E402
from lqrrt_jax.parallel.fleet import FleetPlanner  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()

    n_dev = jax.device_count()
    S = args.scenarios - args.scenarios % n_dev or n_dev
    print(f"devices: {n_dev}, scenarios: {S}")
    prob = boat.default_problem()
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
        batch_size=args.batch, capacity=2048, saturate=prob["saturate"],
        wrap_dims=prob["wrap_dims"], mesh=meshlib.make_fleet_mesh(n_dev))

    # each scenario: same start, randomly perturbed goal (a regatta of boats
    # fanning out to different stations)
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    goals[:, 0] += rng.uniform(-4, 4, S)
    goals[:, 1] += rng.uniform(-6, 6, S)

    # warm-up (compile), then timed
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=1)
    t0 = time.time()
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                       rounds=args.rounds)
    dt_s = time.time() - t0
    eps = stats["expansions"] / dt_s
    print(f"fleet: {S} scenarios x {args.rounds} rounds in {dt_s:.2f}s = "
          f"{eps:,.0f} expansions/s aggregate")
    print(f"fleet: goal rate {stats['goal_found'].mean():.2f}, "
          f"mean nodes {stats['sizes'].mean():.0f}")
    # extract one plan to prove per-scenario results are usable
    plan0 = fleet.extract_plan(0)
    print(f"fleet: scenario 0 plan has {len(plan0)} states, "
          f"ends at {plan0[-1][:2]}")
    return 0 if stats["goal_found"].mean() > 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())

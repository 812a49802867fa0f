"""WAM-V boat demo — the headline workload (reference demos/*, SURVEY.md D3).

Plans a 40 m transit through a buoy field, then simulates the vessel tracking
the plan (feedforward efforts + LQR feedback on the planned state), and saves
a tree/plan figure.

Run:  python demos/boat_demo.py [--replan] [--grid]
  --replan  1 Hz replanning loop from the executed state (the L5 consumer
            pattern, FPR warm-started)
  --grid    occupancy-grid feasibility instead of analytic circles (the
            deployment-grade obstacle model)
"""
import argparse
import sys

import numpy as np

from common import run_replan_loop, run_single

from lqrrt_jax.models import boat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replan", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="boat_demo.png")
    args = ap.parse_args()
    prob = boat.default_problem(
        obstacle_model="grid" if args.grid else "circles")
    gb = np.array([0.3, 0.3, 0, 0, 0, 0], np.float32)
    if args.replan:
        return run_replan_loop("boat", prob, gb, args.out, seed=args.seed)
    return run_single("boat", prob, gb, args.out, seed=args.seed)


if __name__ == "__main__":
    sys.exit(main())

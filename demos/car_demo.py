"""D2: car-like (kinematic bicycle) slalom — nonholonomic steering with
re-linearized (batched-CARE) LQR (SURVEY.md D2).

Run:  python demos/car_demo.py [--replan]
"""
import argparse
import sys

import numpy as np

from common import run_replan_loop, run_single

from lqrrt_jax.models import car


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="car_demo.png")
    args = ap.parse_args()
    prob = car.default_problem()
    gb = np.array([0.25, 0.25, 0.0, 0.0], np.float32)
    if args.replan:
        return run_replan_loop("car", prob, gb, args.out, seed=args.seed)
    # nonholonomic tracking is looser than the holonomic workloads
    return run_single("car", prob, gb, args.out, seed=args.seed, pos_tol=1.5)


if __name__ == "__main__":
    sys.exit(main())

"""D4: 12-state quadrotor through a column field — the heaviest batched-CARE
workload (BASELINE.json configs: "Quadrotor 12-state kinodynamic planning").

Run:  python demos/quadrotor_demo.py [--replan]
"""
import argparse
import sys

import numpy as np

from common import run_replan_loop, run_single

from lqrrt_jax.models import quadrotor as quad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="quadrotor_demo.png")
    args = ap.parse_args()
    prob = quad.default_problem()
    gb = np.zeros(12, np.float32)
    gb[:3] = 0.25
    if args.replan:
        return run_replan_loop("quad", prob, gb, args.out, seed=args.seed,
                               batch_size=128, capacity=4096)
    return run_single("quad", prob, gb, args.out, seed=args.seed, pos_tol=1.0,
                      batch_size=128, capacity=4096)


if __name__ == "__main__":
    sys.exit(main())

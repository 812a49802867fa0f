"""D1: 2-D double-integrator point mass through circular obstacles —
the reference's "hello world" demo workload (SURVEY.md D1).

Run:  python demos/double_integrator_demo.py [--replan]
"""
import argparse
import sys

from common import run_replan_loop, run_single

from lqrrt_jax.models import double_integrator as di


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="double_integrator_demo.png")
    args = ap.parse_args()
    prob = di.default_problem()
    gb = 0.2
    if args.replan:
        return run_replan_loop("di", prob, gb, args.out, seed=args.seed)
    return run_single("di", prob, gb, args.out, seed=args.seed)


if __name__ == "__main__":
    sys.exit(main())

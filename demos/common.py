"""Shared demo driver: plan -> track -> check -> figure (SURVEY.md 3.5).

Every reference demo follows the same pattern (define model callbacks, plan,
simulate tracking the plan, animate).  Here each model module exports a
``default_problem()`` dict, so the demos share this driver.

Tracking runs as ONE jitted lax.scan on device (per-step host dispatch would
dominate wall time), applying feedforward efforts plus LQR feedback about the
planned reference.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax            # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lqrrt_jax      # noqa: E402
from lqrrt_jax.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


def build_planner(prob, seed=0, **overrides):
    kw = dict(min_time=0.3, max_time=1.0,   # the reference ~1 s replan budget
              batch_size=256, capacity=8192, seed=seed,
              wrap_dims=prob.get("wrap_dims", ()),
              saturate=prob.get("saturate"), FPR=0.2)
    kw.update(overrides)
    return lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"], **kw)


def make_tracker(prob):
    """Jitted closed-loop tracker: x_{k+1} = f(x_k, sat(uff_k + K e_k))."""
    dynamics, lqr, erf = prob["dynamics"], prob["lqr"], prob["erf"]
    saturate = prob.get("saturate")
    dt = prob["dt"]

    def step(x, ref):
        xref, uff = ref
        _, K = lqr(xref, uff)
        u = uff + K @ erf(xref, x)
        if saturate is not None:
            u = saturate(u)
        xn = dynamics(x, u, dt)
        return xn, xn

    @jax.jit
    def track(x0, xref_seq, uff_seq):
        _, traj = jax.lax.scan(step, x0, (xref_seq, uff_seq))
        return traj

    return track


def track_plan(prob, planner, extra_steps: int = 40):
    """Simulate the vehicle tracking the committed plan; returns (T+extra, n)
    executed states (including x0)."""
    dt = prob["dt"]
    n_steps = int(planner.T / dt) + extra_steps
    ts = np.arange(n_steps) * dt
    xref = np.stack([planner.get_state(t) for t in ts])
    uff = np.stack([planner.get_effort(t) for t in ts])
    track = make_tracker(prob)
    traj = np.asarray(track(jnp.asarray(prob["x0"]), jnp.asarray(xref),
                            jnp.asarray(uff)))
    return np.concatenate([np.asarray(prob["x0"])[None], traj], axis=0)


def min_clearance(prob, traj, pos_dims=(0, 1)):
    centers, radii = prob["obstacles"]
    if len(centers) == 0:
        return float("inf")
    p = traj[:, list(pos_dims)]
    d = np.linalg.norm(p[:, None] - np.asarray(centers)[None], axis=-1)
    return float((d - np.asarray(radii)[None]).min())


def save_figure(prob, planner, traj, out, dx=0, dy=1):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ax = planner.visualize(dx, dy, show=False)
    ax.plot(traj[:, dx], traj[:, dy], "--", lw=1.5, c="#3355cc",
            label="executed")
    centers, radii = prob["obstacles"]
    for c, r in zip(np.asarray(centers), np.asarray(radii)):
        ax.add_patch(plt.Circle(c, r, fc="#223344", alpha=0.4))
    ax.legend(loc="best")
    plt.savefig(out, dpi=110, bbox_inches="tight")
    print(f"figure saved to {out}")


def run_single(name, prob, goal_bias, out, seed=0, pos_tol=0.5,
               finish_on_goal=True, **planner_overrides):
    """One-shot demo: warm, plan once, track, check, save. Returns exit code."""
    planner = build_planner(prob, seed=seed, **planner_overrides)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=0.05, pruning=False)  # jit warm-up
    t0 = time.time()
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=goal_bias,
                                  finish_on_goal=finish_on_goal)
    print(f"[{name}] plan: reached_goal={reached} in {time.time()-t0:.2f}s "
          f"stats={planner.stats}")
    traj = track_plan(prob, planner)
    err = np.abs(np.asarray(prob["goal"])[:2] - traj[-1][:2])
    clear = min_clearance(prob, traj)
    print(f"[{name}] tracking: final position error = {err} over "
          f"{planner.T:.1f}s plan; min obstacle clearance = {clear:.2f}")
    save_figure(prob, planner, traj, out)
    ok = reached and clear > 0 and float(np.linalg.norm(err)) < pos_tol
    return 0 if ok else 1


def run_replan_loop(name, prob, goal_bias, out, seed=0, hz=1.0,
                    max_replans=30, **planner_overrides):
    """The L5 consumer pattern (SURVEY.md section 3.4): replan at ``hz`` from
    the currently-executed state while tracking the committed plan.  FPR>0
    warm-starts each replan from the previous plan."""
    planner = build_planner(prob, seed=seed, max_time=1.0 / hz,
                            min_time=min(0.3, 1.0 / hz), **planner_overrides)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=0.05, pruning=False)  # jit warm-up
    track = make_tracker(prob)
    dt = prob["dt"]
    exec_steps = max(int(round(1.0 / hz / dt)), 1)
    x = np.asarray(prob["x0"], np.float32)
    full_traj = [x.copy()]
    goal = np.asarray(prob["goal"])
    for k in range(max_replans):
        reached = planner.update_plan(x, prob["sample_space"],
                                      goal_bias=goal_bias)
        # execute 1/hz seconds of the fresh plan
        ts = np.arange(exec_steps) * dt
        xref = np.stack([planner.get_state(t) for t in ts])
        uff = np.stack([planner.get_effort(t) for t in ts])
        seg = np.asarray(track(jnp.asarray(x), jnp.asarray(xref),
                               jnp.asarray(uff)))
        x = seg[-1]
        full_traj.extend(seg)
        pos_err = np.linalg.norm(goal[:2] - x[:2])
        print(f"[{name}] replan {k}: goal={reached} nodes="
              f"{planner.stats['nodes']} pos_err={pos_err:.2f}")
        if reached and pos_err < 1.0:
            break
    traj = np.asarray(full_traj)
    clear = min_clearance(prob, traj)
    print(f"[{name}] replanning run: {k + 1} replans, final pos_err="
          f"{pos_err:.2f}, min clearance = {clear:.2f}")
    save_figure(prob, planner, traj, out)
    return 0 if (pos_err < 1.0 and clear > 0) else 1

"""Batched LQR steering rollouts as vmapped lax.scan.

Reference: Planner._steer closed-loop simulates from the nearest node toward
the target for up to ``horizon`` seconds at resolution dt: each step
e = erf(xtar, x); u = K e; x = dynamics(x, u, dt); stop early on ||e|| <
error_tol or infeasibility, truncating the rollout (SURVEY.md C5,
lqrrt/planner.py ~L340-420).

Re-architecture: the per-step Python loop becomes a lax.scan with a
*static* trip count H and per-step active masking (early stopping via masks,
not control flow), vmapped over the candidate batch (BASELINE.json: "LQR
steer + dynamics integration -> jitted batched ... rollouts").  Variable
length is carried as an integer, and padding steps hold the last state
(SURVEY.md section 7 hard parts: "variable-length rollouts inside scan").
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SteerResult(NamedTuple):
    x_seq: jnp.ndarray    # (B, H, n) rollout states (padded with last state)
    u_seq: jnp.ndarray    # (B, H, m) rollout efforts
    mask: jnp.ndarray     # (B, H) bool, step validity
    length: jnp.ndarray   # (B,) int32 valid steps
    xnew: jnp.ndarray     # (B, n) final feasible state
    reached: jnp.ndarray  # (B,) bool, converged to target within error_tol
    in_goal: jnp.ndarray  # (B,) bool, rollout entered the goal box (only with
                          # goal_buffer set; always False otherwise)


def make_steer(dynamics: Callable, erf: Callable, is_feasible: Callable,
               horizon_steps: int, dt: float, error_tol,
               saturate: Callable | None = None, unroll: int = 4,
               goal_buffer=None, layout: str = "b") -> Callable:
    """Build steer(x0, K, xtar) vmapped over the leading batch axis.

    ``error_tol`` may be a scalar (2-norm threshold, the reference default
    error_tol=0.05) or a per-dim vector (elementwise |e| <= tol).

    ``saturate`` optionally clamps the raw LQR effort u = K e to the actuator
    envelope before it is applied, recorded, and feasibility-checked — the
    reference leaves saturation to the user inside dynamics (SURVEY.md C5);
    doing it here keeps the *recorded* efforts executable so get_effort
    returns what the controller should actually command.

    ``unroll``: scan unroll factor.  The per-step tensors are tiny
    ((B, n) with n ~ 4-12), so the compiled loop's per-iteration overhead
    dominates; unrolling amortizes it.  Semantics are unchanged for any
    factor.

    ``goal_buffer``: optional (n,) goal box.  When set, the returned steer
    takes a trailing ``goal`` argument (shared across the batch) and stops
    each rollout at its FIRST in-goal step (SURVEY.md C6 refinement: the
    reference goal-tests only the rollout endpoint, quantizing time-to-goal
    at horizon multiples; first-entry truncation gives dt resolution).  The
    in-goal test is fused into the scan carry — one extra erf per step —
    instead of a second (B, H, n) sweep over the materialized rollout, which
    cost ~20% of round throughput in round 2.

    ``layout`` selects the scan-carry layout and output convention:

    * "b"  — batch-leading (B, n) carry, vmapped scan, SteerResult fields
      batch-leading (B, H, ·).  The original form; public default.
    * "bt" — batch-TRAILING (n, B) carry, outputs transposed back to the
      (B, H, ·) contract.
    * "tm" — batch-trailing carry AND raw TIME-MAJOR outputs: x_seq
      (H, n, B), u_seq (H, m, B), mask (H, B); per-candidate fields (length,
      xnew, reached, in_goal) stay batch-leading.  This is the production
      round's layout: the scan stacks its outputs time-major natively, and
      handing them out unchanged avoids the (H, n, B) -> (B, H, n)
      transpose of the whole rollout.  Matches the time-major tree edge
      storage (core/tree.py).
    """
    if layout not in ("b", "bt", "tm"):
        raise ValueError(f"unknown steer layout {layout!r}")
    tol = jnp.asarray(error_tol, jnp.float32)
    per_dim = tol.ndim > 0
    gbuf = None if goal_buffer is None else jnp.asarray(goal_buffer,
                                                        jnp.float32)
    if layout in ("bt", "tm"):
        return _make_steer_bt(dynamics, erf, is_feasible, horizon_steps, dt,
                              tol, per_dim, saturate, unroll, gbuf,
                              time_major_out=(layout == "tm"))

    def converged(e):
        if per_dim:
            return jnp.all(jnp.abs(e) <= tol)
        return jnp.linalg.norm(e) <= tol

    def steer_one(x0, K, xtar, goal=None):
        def step(carry, _):
            x, done, length, hit_seen = carry
            e = erf(xtar, x)
            arrived = converged(e)
            u = jnp.dot(K, e, precision=jax.lax.Precision.HIGHEST)
            if saturate is not None:
                u = saturate(u)
            xn = dynamics(x, u, dt)
            feas = is_feasible(xn, u)
            commit = jnp.logical_and(jnp.logical_not(done),
                                     jnp.logical_and(jnp.logical_not(arrived), feas))
            x_out = jnp.where(commit, xn, x)
            length = length + commit.astype(jnp.int32)
            done = done | arrived | jnp.logical_not(feas)
            if gbuf is not None:
                # first-entry goal stop: commit the in-goal step, then halt
                hit = commit & jnp.all(jnp.abs(erf(goal, xn)) <= gbuf)
                hit_seen = hit_seen | hit
                done = done | hit
            return (x_out, done, length, hit_seen), (x_out, u, commit)

        init = (x0, jnp.bool_(False), jnp.asarray(0, jnp.int32),
                jnp.bool_(False))
        (xf, _, length, hit_seen), (xs, us, mask) = jax.lax.scan(
            step, init, None, length=horizon_steps,
            unroll=min(unroll, horizon_steps))
        reached = converged(erf(xtar, xf))
        return SteerResult(xs, us, mask, length, xf, reached, hit_seen)

    if gbuf is None:
        return jax.vmap(steer_one)
    return jax.vmap(steer_one, in_axes=(0, 0, 0, None))


def _make_steer_bt(dynamics, erf, is_feasible, horizon_steps, dt, tol,
                   per_dim, saturate, unroll, gbuf, time_major_out=False):
    """Batch-trailing steer (see make_steer layout="bt"/"tm").

    The user callbacks keep their per-vector (n,)/(m,) signatures; they are
    vmapped over the TRAILING axis, so all scan-carry intermediates are
    (n, B)/(m, B)/(B,) arrays — batch in the lane dimension.  The stacked
    scan outputs come out time-leading (H, n, B)/(H, m, B) and are
    transposed back once to the SteerResult (B, H, ·) contract — two bulk
    relayouts per call instead of ~16x lane padding on every one of the
    H * ~30 per-step ops.
    """
    dynT = jax.vmap(lambda x, u: dynamics(x, u, dt),
                    in_axes=(-1, -1), out_axes=-1)
    erfT = jax.vmap(erf, in_axes=(-1, -1), out_axes=-1)
    feasT = jax.vmap(is_feasible, in_axes=(-1, -1))
    satT = None if saturate is None else jax.vmap(saturate, in_axes=-1,
                                                  out_axes=-1)
    erfgT = None if gbuf is None else jax.vmap(erf, in_axes=(None, -1),
                                               out_axes=-1)

    def converged(e):                       # e: (n, B) -> (B,)
        if per_dim:
            return jnp.all(jnp.abs(e) <= tol[:, None], axis=0)
        return jnp.sqrt(jnp.sum(e * e, axis=0)) <= tol

    def steer(x0, K, xtar, goal=None):
        B = x0.shape[0]
        xT = x0.T                           # (n, B)
        tarT = xtar.T
        KT = jnp.transpose(K, (1, 2, 0))    # (m, n, B)

        def step(carry, _):
            x, done, length, hit_seen = carry
            e = erfT(tarT, x)               # (n, B)
            arrived = converged(e)
            u = jnp.einsum("mnb,nb->mb", KT, e,
                           precision=jax.lax.Precision.HIGHEST)
            if satT is not None:
                u = satT(u)
            xn = dynT(x, u)
            feas = feasT(xn, u)
            commit = jnp.logical_and(
                jnp.logical_not(done),
                jnp.logical_and(jnp.logical_not(arrived), feas))
            x_out = jnp.where(commit[None, :], xn, x)
            length = length + commit.astype(jnp.int32)
            done = done | arrived | jnp.logical_not(feas)
            if gbuf is not None:
                hit = commit & jnp.all(
                    jnp.abs(erfgT(goal, xn)) <= gbuf[:, None], axis=0)
                hit_seen = hit_seen | hit
                done = done | hit
            return (x_out, done, length, hit_seen), (x_out, u, commit)

        init = (xT, jnp.zeros(B, bool), jnp.zeros(B, jnp.int32),
                jnp.zeros(B, bool))
        (xf, _, length, hit_seen), (xs, us, mask) = jax.lax.scan(
            step, init, None, length=horizon_steps,
            unroll=min(unroll, horizon_steps))
        reached = converged(erfT(tarT, xf))
        if time_major_out:
            return SteerResult(xs, us, mask, length, xf.T, reached, hit_seen)
        x_seq = jnp.transpose(xs, (2, 0, 1))   # (H, n, B) -> (B, H, n)
        u_seq = jnp.transpose(us, (2, 0, 1))
        return SteerResult(x_seq, u_seq, mask.T, length, xf.T, reached,
                           hit_seen)

    return steer

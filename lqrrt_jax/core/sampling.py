"""On-device batched state sampling with per-dimension goal biasing.

Reference: the default sampler inside update_plan draws uniform samples over
caller-supplied per-dim ``sample_space`` boxes, and per dimension i replaces
the sample with goal[i] with probability goal_bias[i]; an optional ``guide``
state substitutes for the goal as the bias target (SURVEY.md C3,
lqrrt/planner.py ~L150-200).

Device delta: one fused jax.random draw yields the whole candidate batch
(BASELINE.json: "goal-biasing/resample logic -> on-device PRNG").  A user
``xrand_gen(key, batch)`` generator can replace the default entirely, but must
be traceable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_batch(key, batch: int, sample_space, goal_bias, bias_target):
    """Draw (batch, n) candidate states.

    sample_space: (n, 2) [min, max] per dim; goal_bias: (n,) probabilities;
    bias_target: (n,) goal (or guide) state.
    """
    n = sample_space.shape[0]
    k_uni, k_bias = jax.random.split(key)
    lo, hi = sample_space[:, 0], sample_space[:, 1]
    xr = jax.random.uniform(k_uni, (batch, n), jnp.float32) * (hi - lo) + lo
    take_goal = jax.random.uniform(k_bias, (batch, n)) < goal_bias
    return jnp.where(take_goal, bias_target, xr)


def normalize_goal_bias(goal_bias, nstates: int) -> jnp.ndarray:
    """Accept the reference's scalar-or-per-dim goal_bias (SURVEY.md C3)."""
    gb = jnp.asarray(goal_bias, jnp.float32)
    if gb.ndim == 0:
        gb = jnp.full((nstates,), gb)
    if gb.shape != (nstates,):
        raise ValueError(f"goal_bias must be scalar or ({nstates},), got {gb.shape}")
    return gb

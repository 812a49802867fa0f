"""Problem specification record — API parity with the reference Constraints.

Reference: lqrrt/constraints.py (~L1-80) class Constraints holding nstates,
ncontrols, goal_buffer, search_buffer, and the user is_feasible(x, u)
predicate, with a setter to swap the feasibility function at runtime for
dynamic obstacle updates (SURVEY.md C9).  [Reference mount was empty at survey
time — citations are to the public repo per SURVEY.md's provenance warning.]

Deltas: buffers are stored as jnp arrays; ``is_feasible`` must be
jax-traceable on a single (x, u) pair — the planner vmaps it across
(batch x rollout-step).  Swapping the feasibility function invalidates the
planner's compiled round (it retriggers a trace), which the Planner handles
automatically.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class Constraints:
    def __init__(self, nstates: int, ncontrols: int, goal_buffer,
                 search_buffer=None, is_feasible: Callable = None,
                 feasibility_data=None):
        self.nstates = int(nstates)
        self.ncontrols = int(ncontrols)
        # numpy storage: backend-neutral; jit embeds these as constants
        self.goal_buffer = np.asarray(goal_buffer, np.float32)
        if self.goal_buffer.shape != (self.nstates,):
            raise ValueError(
                f"goal_buffer must have shape ({self.nstates},), got {self.goal_buffer.shape}")
        if search_buffer is None:
            search_buffer = np.zeros((self.nstates, 2), np.float32)
        self.search_buffer = np.asarray(search_buffer, np.float32).reshape(self.nstates, 2)
        if is_feasible is None:
            import jax.numpy as jnp
            is_feasible = lambda x, u: jnp.bool_(True)
        self.feasibility_data = feasibility_data
        self.set_feasibility_function(is_feasible)

    def sample_space(self, x0, goal):
        """Per-dim sampling box spanning the x0->goal span padded by
        search_buffer — the pattern the reference's callers use to build
        update_plan's sample_space around the transit region (SURVEY.md C9:
        search_buffer is "per-dim (min,max) offsets used by callers to build
        sample_space around the x0->goal region" [MED])."""
        x0 = np.asarray(x0, np.float32).reshape(self.nstates)
        goal = np.asarray(goal, np.float32).reshape(self.nstates)
        lo = np.minimum(x0, goal) + self.search_buffer[:, 0]
        hi = np.maximum(x0, goal) + self.search_buffer[:, 1]
        return np.stack([lo, hi], axis=1)

    def set_feasibility_function(self, is_feasible: Callable):
        """Swap the feasibility predicate (dynamic obstacle updates,
        reference lqrrt/constraints.py set_feasibility_function [MED]).

        This replaces the *code* of the predicate, so the planner re-traces
        its compiled round on the next update_plan (seconds of compile).
        For obstacle updates that only change *data* (a moving
        buoy field, a refreshed occupancy grid), use ``feasibility_data`` +
        ``set_feasibility_data`` instead: the data rides through the already
        compiled round as a traced argument, zero recompiles.
        """
        if not callable(is_feasible):
            raise ValueError("is_feasible must be callable (x, u) -> bool")
        self.is_feasible = is_feasible
        # monotonically bumped so the Planner knows to re-trace its round
        self._feasibility_version = getattr(self, "_feasibility_version", -1) + 1

    def set_feasibility_data(self, data):
        """Swap the obstacle DATA consumed by a 3-arg predicate
        ``is_feasible(x, u, data)`` without invalidating compiled rounds.

        ``data`` is any pytree of arrays whose shapes/dtypes stay constant
        across updates (e.g. a fixed-size occupancy grid, or (K, 2) circle
        centers with (K,) radii, padding unused slots with radius <= 0).
        Shape changes trigger one recompile, value changes none.
        """
        if self.feasibility_data is None:
            raise ValueError(
                "constraints were built without feasibility_data; construct "
                "with feasibility_data=... and a 3-arg is_feasible(x, u, data)")
        self.feasibility_data = data

"""Checkpoint / resume (SURVEY.md section 5.4).

The reference's only persistent state is the committed plan (x_seq, u_seq, T);
each update_plan rebuilds the tree from the new x0.  Mirroring that, a
checkpoint captures the planner's mission state — goal, committed plan,
PRNG key, replan stats — and optionally the full SoA tree arrays, as one npz
(SoA storage makes this trivial: every tree field is already a dense array).

Restart mid-mission: ``save(planner, path)`` then ``load(planner, path)``
into a freshly-constructed Planner with the same problem spec (callbacks are
code, not data — they are NOT serialized, same as the reference where
dynamics/lqr/is_feasible live in the calling program).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# Bump on ANY layout change (a field added with a silent back-fill can
# corrupt the next one silently).  History:
#   2 — pre-n_children layout (the 2->3 migration back-fills child counts)
#   3 — adds tree_n_children
#   4 — edge arrays stored TIME-MAJOR (H, ., N) instead of (N, H, .)
#       (core/tree.py round-4 relayout; 3->4 migration transposes)
_FORMAT = 4
_COMPAT = (2, 3, 4)   # formats load() accepts (older ones via migration)


def save(planner, path: str, include_tree: bool = False):
    """Write planner mission state to ``path`` (.npz)."""
    data = dict(
        format=np.int64(_FORMAT),
        nstates=np.int64(planner.nstates),
        ncontrols=np.int64(planner.ncontrols),
        dt=np.float64(planner.dt),
        key=np.asarray(planner._key),
        plan_reached_goal=np.bool_(planner.plan_reached_goal),
        has_plan=np.bool_(planner._plan is not None),
        has_goal=np.bool_(planner.goal is not None),
    )
    if planner.goal is not None:
        data["goal"] = np.asarray(planner.goal)
    if planner._plan is not None:
        x_seq, u_seq, T = planner._plan
        data["x_seq"] = np.asarray(x_seq)
        data["u_seq"] = np.asarray(u_seq)
        data["T"] = np.float64(T)
    if include_tree and planner._device_tree is not None:
        tree = planner._device_tree
        for field in tree._fields:
            data[f"tree_{field}"] = np.asarray(getattr(tree, field))
    np.savez_compressed(path, **data)


def load(planner, path: str):
    """Restore mission state saved by ``save`` into ``planner``.

    The planner must be constructed with the same problem dimensions; the
    checkpoint's dims are validated against it.
    """
    with np.load(path) as z:
        if int(z["format"]) not in _COMPAT:
            raise ValueError(f"checkpoint format {int(z['format'])} not in "
                             f"supported {_COMPAT}")
        if int(z["nstates"]) != planner.nstates or \
           int(z["ncontrols"]) != planner.ncontrols:
            raise ValueError(
                "checkpoint dims "
                f"({int(z['nstates'])}, {int(z['ncontrols'])}) do not match "
                f"planner ({planner.nstates}, {planner.ncontrols})")
        planner._key = jnp.asarray(z["key"])
        planner.plan_reached_goal = bool(z["plan_reached_goal"])
        if bool(z["has_goal"]):
            planner.set_goal(z["goal"])
        if bool(z["has_plan"]):
            planner._plan = (z["x_seq"].astype(np.float32),
                             z["u_seq"].astype(np.float32),
                             float(z["T"]))
        tree_fields = [k for k in z.files if k.startswith("tree_")]
        if tree_fields:
            from ..core.tree import TreeArrays
            kwargs = {k[len("tree_"):]: jnp.asarray(z[k])
                      for k in tree_fields}
            if int(z["format"]) < 4:
                # 3 -> 4 migration: edge arrays were row-major (N, H, .);
                # current storage is time-major (H, ., N)
                for f in ("edge_x", "edge_u"):
                    kwargs[f] = jnp.transpose(kwargs[f], (1, 2, 0))
            if "n_children" not in kwargs:
                # 2 -> 3 migration: checkpoints written before child counting
                # existed — reconstruct counts from the parent array (exact).
                # Only rows with a real incoming edge count: commit_all-era
                # trees store zero-length duplicate rows that never
                # contribute (pre-commit_all trees have no such rows, so the
                # mask is a no-op there).
                parent = np.asarray(kwargs["parent"])
                edge_len = np.asarray(kwargs["edge_len"])
                size = int(np.asarray(kwargs["size"]))
                counts = np.zeros(parent.shape[0], np.int32)
                rows = np.arange(size)
                ok = (rows >= 1) & (edge_len[:size] >= 1) & \
                    (parent[:size] >= 0)
                np.add.at(counts, parent[:size][ok], 1)
                kwargs["n_children"] = jnp.asarray(counts)
            planner._device_tree = TreeArrays(**kwargs)
            planner.tree = None
    return planner

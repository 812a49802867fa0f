"""Host-facing Tree — API parity with the reference's lqrrt/tree.py.

Reference: class Tree stores parallel lists (state array, per-node (S, K),
per-edge rollouts, parent IDs with root = -1, size) and provides
``add_node(ID, state, lqr, x_seq, u_seq)``, ``climb(ID)`` (root->ID index
chain) and ``trajectory(IDs)`` (concatenated per-edge rollouts)
(SURVEY.md C8, lqrrt/tree.py ~L1-120).

This host class keeps that exact contract for users and for plan extraction;
the device-resident planner uses the fixed-capacity SoA representation in
lqrrt_jax/core/tree.py and snapshots into this class on demand.
"""
from __future__ import annotations

import numpy as np


class Tree:
    def __init__(self, seed_state, seed_lqr):
        seed_state = np.asarray(seed_state, np.float32)
        self.state = seed_state[None, :].copy()
        self.lqr = [seed_lqr]
        self.x_seq = [seed_state[None, :]]
        self.u_seq = [np.zeros((0, 0), np.float32)]
        self.pID = [-1]
        self.size = 1

    def add_node(self, ID: int, state, lqr, x_seq, u_seq) -> int:
        """Append a node whose incoming edge rollout is (x_seq, u_seq) and
        whose parent is ID. Returns the new node's index."""
        if not (0 <= ID < self.size):
            raise IndexError(f"parent {ID} out of range (size={self.size})")
        self.state = np.vstack([self.state, np.asarray(state, np.float32)[None, :]])
        self.lqr.append(lqr)
        self.x_seq.append(np.asarray(x_seq, np.float32))
        self.u_seq.append(np.asarray(u_seq, np.float32))
        self.pID.append(int(ID))
        self.size += 1
        return self.size - 1

    def climb(self, ID: int):
        """Index chain from root to ID (inclusive)."""
        chain = []
        while ID != -1:
            chain.append(int(ID))
            ID = self.pID[ID]
        return chain[::-1]

    def trajectory(self, IDs):
        """Concatenate the per-edge rollouts along the chain IDs."""
        xs, us = [], []
        for ID in IDs:
            if ID == 0:
                continue  # root has no incoming edge
            xs.append(self.x_seq[ID])
            us.append(self.u_seq[ID])
        if not xs:
            return (self.state[:1].copy(),
                    np.zeros((0, 0), np.float32))
        return np.concatenate(xs, axis=0), np.concatenate(us, axis=0)

    @classmethod
    def from_device_arrays(cls, arrays) -> "Tree":
        """Snapshot a core.tree.TreeArrays into a host Tree (trimmed edges).

        Fields are assembled directly (one device_get, one state copy) —
        replaying add_node would vstack per node, O(size^2) copies for a
        32k-node tree.

        The sort-free commit (commit_batch_dense_all) stores empty-rollout
        candidates as inert zero-length duplicates of their parent; the
        reference tree model has no such rows, so the snapshot COMPACTS them
        out, remapping any child of a dead row to its nearest live
        equivalent — exact, because a dead row's state IS its parent's."""
        import jax
        host = jax.device_get(arrays)
        size = int(host.size)
        lens = np.asarray(host.edge_len[:size], np.int64)
        parent = np.asarray(host.parent[:size], np.int64)
        keep = lens > 0
        keep[0] = True
        # dead row -> nearest live ancestor-equivalent (parents always
        # precede children in commit order, so one forward pass suffices)
        equiv = np.arange(size)
        for i in range(1, size):
            if not keep[i]:
                equiv[i] = equiv[parent[i]]
        new_idx = np.cumsum(keep) - 1          # kept-row renumbering
        rows = np.flatnonzero(keep)

        t = cls(host.state[0], (host.S[0], host.K[0]))
        t.state = np.asarray(host.state[rows], np.float32).copy()
        t.lqr = [(host.S[i], host.K[i]) for i in rows]
        # device edge storage is time-major (H, ·, N); slice per node
        t.x_seq = [t.state[:1].copy()] + [
            np.asarray(host.edge_x[:lens[i], :, i], np.float32)
            for i in rows[1:]]
        t.u_seq = [np.zeros((0, 0), np.float32)] + [
            np.asarray(host.edge_u[:lens[i], :, i], np.float32)
            for i in rows[1:]]
        t.pID = [-1] + [int(new_idx[equiv[parent[i]]]) for i in rows[1:]]
        t.size = len(rows)
        return t

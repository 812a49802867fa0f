"""Device mesh construction helpers.

The reference has no distributed anything (SURVEY.md section 2.4); the new
framework scales over a jax.sharding.Mesh, and XLA hands its collectives to
NCCL (SURVEY.md section 5.8).  The GPUs of one host are joined all to all by
NVLink, so a mesh follows the algorithm only, not a physical topology.

Mesh axes:
  "dp"       — candidate-batch data parallelism (P1): each device samples and
               steers a shard of the round's candidate batch.
  "scenario" — fleet parallelism (P4): independent planner instances
               (1k-boat replanning config) sharded across devices.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n_devices local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_fleet_mesh(n_devices: int | None = None) -> Mesh:
    return make_mesh(n_devices, axis="scenario")


def make_mesh_2d(n_hosts: int, chips_per_host: int | None = None,
                 axes: tuple[str, str] = ("host", "dp")) -> Mesh:
    """2-D (hosts x devices) mesh (P5, SURVEY.md 2.4): the leading axis maps
    across hosts (collectives over it cross the network between hosts), the
    trailing axis across each host's GPUs (NVLink).

    Device order: jax.devices() groups devices by process on a multi-host
    deployment, so reshaping to (n_hosts, chips_per_host) puts each row on
    one host.  The candidate-sharded round shards over BOTH axes by passing
    ``axis=axes`` (a tuple) to make_sharded_round*; its collectives then
    reduce over both axes.
    """
    devs = jax.devices()
    if chips_per_host is None:
        if len(devs) % n_hosts != 0:
            raise ValueError(
                f"{len(devs)} devices not divisible by n_hosts={n_hosts}")
        chips_per_host = len(devs) // n_hosts
    need = n_hosts * chips_per_host
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.asarray(devs[:need]).reshape(n_hosts, chips_per_host)
    return Mesh(grid, axes)


def make_mesh_dp_map(n_dp: int, n_map: int | None = None,
                     axes: tuple[str, str] = ("dp", "map")) -> Mesh:
    """2-D (dp x map) mesh for the P1 x P3 composed rounds: candidate batch
    sharded over ``dp``, occupancy-grid slabs over ``map``
    (parallel/map_sharded.py; reachable from Planner(mesh=...,
    feasibility_grid=...)).  Pass n_dp=1 for a pure map-sharded (P3)
    deployment."""
    devs = jax.devices()
    if n_map is None:
        if len(devs) % n_dp != 0:
            raise ValueError(
                f"{len(devs)} devices not divisible by n_dp={n_dp}")
        n_map = len(devs) // n_dp
    need = n_dp * n_map
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(n_dp, n_map), axes)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host bring-up (P5): jax.distributed.initialize.

    On a multi-host deployment every host calls this before building the
    mesh; jax.devices() then spans every host's GPUs.  No-op when everything
    is single-process (the common path).
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_leading(mesh: Mesh, axis: str) -> NamedSharding:
    return NamedSharding(mesh, P(axis))

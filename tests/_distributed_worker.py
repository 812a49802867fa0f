"""Worker for the 2-process jax.distributed test (P5, SURVEY.md 2.4).

Each process owns 4 virtual CPU devices; after parallel.mesh.init_distributed
the global device count is 8 across 2 processes.  The worker builds the 2-D
(hosts x chips) mesh over the GLOBAL device set, checks a flat-index psum,
then runs one candidate-sharded expansion round of the double-integrator
problem and prints the resulting tree size — the same collectives a real
2-host deployment would run over the network between hosts and NVLink
within each.

Usage: python _distributed_worker.py <coordinator> <num_procs> <process_id>
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, num_procs, pid = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]))
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from lqrrt_jax.parallel import mesh as meshlib

    meshlib.init_distributed(coordinator, num_procs, pid)
    assert jax.process_count() == num_procs, jax.process_count()
    n_global = jax.device_count()
    assert n_global == 4 * num_procs, n_global
    mesh = meshlib.make_mesh_2d(num_procs, 4)

    # --- collective smoke: sum of flat device ids over (host, dp) ---
    def ids(_):
        i = jax.lax.axis_index(("host", "dp"))
        return jax.lax.psum(jnp.float32(i), ("host", "dp"))[None]

    out = jax.jit(jax.shard_map(
        ids, mesh=mesh, in_specs=P(), out_specs=P(),
        check_vma=False))(jnp.zeros(()))
    # fully-replicated result: every process reads its local replica
    total = float(np.asarray(out.addressable_shards[0].data).ravel()[0])
    expect = n_global * (n_global - 1) / 2
    assert total == expect, (total, expect)
    print(f"PSUM_OK {pid} {total}", flush=True)

    # --- one sharded expansion round over the 2-process mesh ---
    from lqrrt_jax.core.rounds import RoundSpec
    from lqrrt_jax.core.tree import init_tree
    from lqrrt_jax.models import double_integrator as di
    from lqrrt_jax.parallel.sharded import make_sharded_round

    prob = di.default_problem()
    spec = RoundSpec(nstates=4, ncontrols=2, batch=8 * n_global,
                     horizon_steps=10, capacity=256, dt=0.05, nn_block=128)
    S0, K0 = prob["lqr"](None, None)
    tree = init_tree(spec.capacity, spec.horizon_steps, 4, 2,
                     jnp.asarray(prob["x0"]), S0, K0, 1e9, False)
    rep = NamedSharding(mesh, P())
    tree = jax.tree.map(
        lambda x: jax.make_array_from_callback(
            x.shape, rep, lambda idx: np.asarray(x)[idx]), tree)
    rf = jax.jit(make_sharded_round(
        spec, mesh, prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, 0.05,
        prob["constraints"].goal_buffer, saturate=prob["saturate"],
        axis=("host", "dp")))
    args = [jax.device_put(a, rep) for a in (
        jnp.asarray(prob["goal"]), jnp.asarray(prob["sample_space"]),
        jnp.full((4,), 0.2), jnp.asarray(prob["goal"]))]
    out_tree = rf(tree, jax.device_put(jax.random.PRNGKey(0), rep), *args)
    size = int(np.asarray(
        out_tree.size.addressable_shards[0].data).ravel()[0])
    assert size > 1, size
    print(f"ROUND_OK {pid} {size}", flush=True)

    # --- FULL Planner.update_plan across the process boundary: the chunked anytime facade — fused on-device restarts,
    # candidate sharding over (host, dp), best-edge all-gather across hosts,
    # extraction — must commit BIT-IDENTICAL plans in both processes.  The
    # injected clock is call-counted, so both processes execute the exact
    # same number of chunks (wall-clock divergence would deadlock the
    # collectives — this is precisely the host-loop logic only a real
    # cross-process run can validate). ---
    import lqrrt_jax

    calls = {"n": 0}

    def clock():
        calls["n"] += 1
        return 0.0 if calls["n"] <= 6 else 1e9

    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=8 * n_global, capacity=256, nn_block=128,
        saturate=prob["saturate"], seed=3, mesh=mesh,
        mesh_axis=("host", "dp"), rounds_per_chunk=4)
    planner.sys_time = clock
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, pruning=False)
    xs = np.asarray(planner.x_seq, np.float64)
    digest = (int(reached), len(xs), planner.stats["nodes"],
              round(float(np.abs(xs).sum()), 3))
    print(f"PLAN_OK {pid} {digest}", flush=True)

    # --- fleet (P4) across the process boundary: the
    # 1k-scenario BASELINE config is "sharded across >=2 hosts"; this runs a
    # 16-scenario double-integrator fleet over the flattened 8-device global
    # mesh in fixed-rounds mode (deterministic — no wall clock to diverge
    # between processes) and digests per-scenario sizes/goals through a
    # replicated-output reduction both processes must agree on. ---
    from lqrrt_jax.parallel.fleet import FleetPlanner

    fmesh = meshlib.make_fleet_mesh(n_global)
    S = 16
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    goals[:, 0] += rng.uniform(-1, 1, S).astype(np.float32)
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
        batch_size=16, capacity=128, nn_block=64,
        saturate=prob["saturate"], mesh=fmesh, seed=5)
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2, rounds=4)
    rep_f = NamedSharding(fmesh, P())
    dig = jax.jit(
        lambda ts: (jnp.sum(ts.size), jnp.sum(ts.goal_found.astype(
            jnp.int32)), jnp.sum(jnp.abs(ts.state))),
        out_shardings=(rep_f, rep_f, rep_f))(fleet.trees)
    sizes_sum, goals_sum, state_sum = (
        float(np.asarray(d.addressable_shards[0].data).ravel()[0])
        for d in dig)
    fdigest = (int(sizes_sum), int(goals_sum), round(state_sum, 2))
    print(f"FLEET_OK {pid} {fdigest}", flush=True)


if __name__ == "__main__":
    main()

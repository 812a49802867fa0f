"""P3 obstacle-map sharding: the map-sharded round (grid split row-wise over
8 virtual devices, verdicts psum-reduced) must commit exactly the edges the
single-device round commits with the full grid checked inside steering —
post-hoc truncation at the first occupied step is exact, not approximate
(see parallel/map_sharded.py module docstring)."""
import numpy as np

import jax
import jax.numpy as jnp

from lqrrt_jax.core.rounds import RoundSpec, make_round
from lqrrt_jax.core.tree import init_tree
from lqrrt_jax.models import double_integrator as di
from lqrrt_jax.ops import collision
from lqrrt_jax.parallel import mesh as meshlib
from lqrrt_jax.parallel.map_sharded import ShardedGrid, make_map_sharded_round


def _grid_world():
    """A wall with a gap, rasterized: x in [0, 16], y in [0, 16]."""
    res = 0.25
    H = W = 64
    occ = np.zeros((H, W), bool)
    occ[:, 28:32] = True          # vertical wall at x in [7, 8)
    occ[24:32, 28:32] = False     # gap at y in [6, 8)
    return occ, np.zeros(2, np.float32), res


def _setup(batch=32, cap=256, horizon=20):
    prob = di.default_problem(obstacles=False)
    occ, origin, res = _grid_world()
    spec = RoundSpec(4, 2, batch, horizon, cap, prob["dt"],
                     nn_block=min(128, cap), slack=batch)
    S0, K0 = prob["lqr"](None, None)
    x0 = jnp.asarray([2.0, 7.0, 0.0, 0.0])
    goal = jnp.asarray([14.0, 7.0, 0.0, 0.0])
    ss = jnp.asarray([[0.0, 16.0], [0.0, 16.0], [-2.0, 2.0], [-2.0, 2.0]],
                     jnp.float32)
    tree = init_tree(cap, horizon, 4, 2, x0, S0, K0, 1e9, False,
                     slack=batch)
    return prob, spec, occ, origin, res, tree, goal, ss


def test_map_sharded_round_matches_single_device():
    n_dev = jax.device_count()
    assert n_dev == 8
    prob, spec, occ, origin, res, tree, goal, ss = _setup()
    gb = jnp.full((4,), 0.2)
    key = jax.random.PRNGKey(7)

    # single-device reference: full grid inside steer
    full_grid = collision.OccupancyGrid(occ, origin, res)
    ref_round = jax.jit(make_round(
        spec, prob["dynamics"], prob["lqr"], prob["erf"],
        full_grid.is_feasible, 0.05, prob["constraints"].goal_buffer))
    ref = ref_round(tree, key, goal, ss, gb, goal)

    # map-sharded: grid rows split over 8 devices, trivial local predicate
    mesh = meshlib.make_mesh(n_dev, axis="map")
    sgrid = ShardedGrid(occ, origin, res, n_shards=n_dev)
    sh_round = jax.jit(make_map_sharded_round(
        spec, mesh, sgrid, prob["dynamics"], prob["lqr"], prob["erf"],
        lambda x, u: jnp.bool_(True), 0.05,
        prob["constraints"].goal_buffer))
    out = sh_round(tree, jnp.asarray(sgrid.occ_sharded), key, goal, ss, gb,
                   goal)

    assert int(out.size) == int(ref.size) > 1
    assert bool(out.goal_found) == bool(ref.goal_found)
    sz = int(ref.size)
    np.testing.assert_array_equal(np.asarray(out.parent[:sz]),
                                  np.asarray(ref.parent[:sz]))
    np.testing.assert_array_equal(np.asarray(out.edge_len[:sz]),
                                  np.asarray(ref.edge_len[:sz]))
    np.testing.assert_allclose(np.asarray(out.state[:sz]),
                               np.asarray(ref.state[:sz]), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.in_goal[:sz]),
                                  np.asarray(ref.in_goal[:sz]))
    # committed rollout prefixes match step-for-step
    lens = np.asarray(ref.edge_len[:sz])
    ex_ref = np.asarray(ref.edge_x[..., :sz])      # time-major (H, n, N)
    ex_out = np.asarray(out.edge_x[..., :sz])
    for i in range(1, sz):
        ln = int(lens[i])
        np.testing.assert_allclose(ex_out[:ln, :, i], ex_ref[:ln, :, i],
                                   atol=1e-5)


def test_map_sharded_multi_round_plans_through_gap():
    """Several map-sharded rounds grow a tree that threads the wall gap."""
    n_dev = jax.device_count()
    prob, spec, occ, origin, res, tree, goal, ss = _setup(batch=64, cap=512)
    spec = spec._replace(batch=64, slack=64)
    mesh = meshlib.make_mesh(n_dev, axis="map")
    sgrid = ShardedGrid(occ, origin, res, n_shards=n_dev)
    rf = jax.jit(make_map_sharded_round(
        spec, mesh, sgrid, prob["dynamics"], prob["lqr"], prob["erf"],
        lambda x, u: jnp.bool_(True), 0.05,
        prob["constraints"].goal_buffer), donate_argnums=(0,))
    slab = jnp.asarray(sgrid.occ_sharded)
    gb = jnp.asarray([0.3, 0.3, 0.0, 0.0])
    base = jax.random.PRNGKey(3)
    # re-init the tree to match the larger spec: cap 512 + slack 64
    S0, K0 = prob["lqr"](None, None)
    t = init_tree(512, spec.horizon_steps, 4, 2,
                  jnp.asarray([2.0, 7.0, 0.0, 0.0]), S0, K0, 1e9, False,
                  slack=64)
    for r in range(6):
        t = rf(t, slab, jax.random.fold_in(base, r), goal, ss, gb, goal)
    assert int(t.size) > 32
    # every committed node is collision-free w.r.t. the full grid
    full = collision.OccupancyGrid(occ, origin, res)
    sz = int(t.size)
    states = np.asarray(t.state[:sz])
    occ_v = np.asarray(full.occupied(jnp.asarray(states[:, :2])))
    assert not occ_v.any()


def test_planner_facade_grid_mesh_e2e():
    """Facade-level P3: a user with a sharded grid
    calls plain update_plan — Planner(mesh=(dp x map), feasibility_grid=...)
    runs the composed dp x map chunk with the full anytime surface (budget,
    restarts, pruning, finish_on_goal, extraction) and the plan threads the
    wall gap without ever touching an occupied cell."""
    import lqrrt_jax
    from lqrrt_jax.parallel.mesh import make_mesh_dp_map

    prob = di.default_problem(obstacles=False)
    occ, origin, res = _grid_world()
    n_dp, n_map = 2, 4
    mesh = make_mesh_dp_map(n_dp, n_map)
    sgrid = ShardedGrid(occ, origin, res, n_shards=n_map)
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=1.0, dt=prob["dt"],
        goal0=[14.0, 7.0, 0.0, 0.0], printing=False, batch_size=64,
        capacity=512, nn_block=128, saturate=prob["saturate"], seed=4,
        mesh=mesh, mesh_axis="dp", feasibility_grid=sgrid, map_axis="map")
    ss = [[0.0, 16.0], [0.0, 16.0], [-2.0, 2.0], [-2.0, 2.0]]
    reached = planner.update_plan([2.0, 7.0, 0.0, 0.0], ss,
                                  goal_bias=[0.3, 0.3, 0, 0], pruning=True,
                                  finish_on_goal=True, specific_time=25.0)
    assert reached
    xs = np.asarray(planner.x_seq)
    # crossed the wall: starts left of it, ends right of it
    assert xs[0][0] < 7.0 and xs[-1][0] > 13.0
    # no plan state in an occupied cell (full-grid host check)
    assert not sgrid.occupied_host(xs[:, :2]).any()
    # ends inside the goal box
    err = np.abs(np.asarray(planner.goal) - xs[-1])
    assert np.all(err <= np.asarray(prob["constraints"].goal_buffer) + 1e-5)


def test_dp_map_composed_round_matches_single_device():
    """P1 x P3 composition (round-1 review, missing item 3): candidates
    sharded over 'dp' AND grid rows over 'map' on a 2x4 mesh must commit
    exactly what the single-device round commits with the full grid inside
    steering and the emulated per-dp-row sample folds."""
    from lqrrt_jax.core.sampling import sample_batch
    from lqrrt_jax.parallel.map_sharded import make_dp_map_round

    n_dp, n_map = 2, 4
    prob, spec, occ, origin, res, tree, goal, ss = _setup(batch=32)
    gb = jnp.full((4,), 0.2)
    key = jax.random.PRNGKey(11)

    # single-device reference with the emulated dp-sharded sample batch
    def emulate(k, B):
        xs = []
        for d in range(n_dp):
            xs.append(sample_batch(jax.random.fold_in(k, d), B // n_dp,
                                   ss, gb, goal))
        return jnp.concatenate(xs, 0)

    full_grid = collision.OccupancyGrid(occ, origin, res)
    ref_round = jax.jit(make_round(
        spec, prob["dynamics"], prob["lqr"], prob["erf"],
        full_grid.is_feasible, 0.05, prob["constraints"].goal_buffer,
        xrand_gen=emulate))
    ref = ref_round(tree, key, goal, ss, gb, goal)

    mesh = meshlib.make_mesh_2d(n_dp, n_map, axes=("dp", "map"))
    sgrid = ShardedGrid(occ, origin, res, n_shards=n_map)
    rf = jax.jit(make_dp_map_round(
        spec, mesh, sgrid, prob["dynamics"], prob["lqr"], prob["erf"],
        lambda x, u: jnp.bool_(True), 0.05,
        prob["constraints"].goal_buffer))
    out = rf(tree, jnp.asarray(sgrid.occ_sharded), key, goal, ss, gb, goal)

    assert int(out.size) == int(ref.size) > 1
    sz = int(ref.size)
    np.testing.assert_array_equal(np.asarray(out.parent[:sz]),
                                  np.asarray(ref.parent[:sz]))
    np.testing.assert_array_equal(np.asarray(out.edge_len[:sz]),
                                  np.asarray(ref.edge_len[:sz]))
    np.testing.assert_allclose(np.asarray(out.state[:sz]),
                               np.asarray(ref.state[:sz]), atol=1e-5)
    # committed rollout prefixes match step-for-step
    lens = np.asarray(ref.edge_len[:sz])
    ex_ref = np.asarray(ref.edge_x[..., :sz])      # time-major (H, n, N)
    ex_out = np.asarray(out.edge_x[..., :sz])
    for i in range(1, sz):
        np.testing.assert_allclose(ex_out[:int(lens[i]), :, i],
                                   ex_ref[:int(lens[i]), :, i], atol=1e-5)

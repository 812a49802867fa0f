"""Collision / feasibility primitive tests vs brute-force geometry."""
import numpy as np
import jax
import jax.numpy as jnp

from lqrrt_jax.ops import collision


def test_circles_free():
    pred = collision.circles_free(centers=[[0.0, 0.0], [5.0, 5.0]],
                                  radii=[1.0, 2.0])
    u = jnp.zeros(2)
    assert not bool(pred(jnp.array([0.5, 0.0, 9, 9]), u))
    assert bool(pred(jnp.array([2.0, 0.0, 9, 9]), u))
    assert not bool(pred(jnp.array([4.0, 4.0, 9, 9]), u))
    # margin inflates the obstacle
    pred_m = collision.circles_free([[0.0, 0.0]], [1.0], margin=0.5)
    assert not bool(pred_m(jnp.array([1.2, 0.0]), jnp.zeros(2)))
    assert bool(pred_m(jnp.array([1.6, 0.0]), jnp.zeros(2)))


def test_circles_free_vmap_matches_loop():
    rng = np.random.default_rng(0)
    centers = rng.uniform(-5, 5, (10, 2)).astype(np.float32)
    radii = rng.uniform(0.2, 1.5, 10).astype(np.float32)
    pred = collision.circles_free(centers, radii)
    pts = rng.uniform(-6, 6, (200, 4)).astype(np.float32)
    got = np.asarray(jax.vmap(lambda x: pred(x, jnp.zeros(2)))(jnp.array(pts)))
    want = np.array([np.all(np.linalg.norm(centers - p[:2], axis=1) > radii)
                     for p in pts])
    np.testing.assert_array_equal(got, want)


def test_control_limits_and_state_box():
    cl = collision.control_limits([-1.0, -2.0], [1.0, 2.0])
    assert bool(cl(jnp.zeros(3), jnp.array([0.5, -1.5])))
    assert not bool(cl(jnp.zeros(3), jnp.array([1.5, 0.0])))
    sb = collision.state_box([-1.0], [1.0], dims=[2])
    assert bool(sb(jnp.array([9.0, 9.0, 0.5]), None))
    assert not bool(sb(jnp.array([0.0, 0.0, 1.5]), None))


def test_all_of():
    a = collision.control_limits([-1.0], [1.0])
    b = collision.state_box([0.0], [10.0], dims=[0])
    both = collision.all_of(a, b)
    assert bool(both(jnp.array([5.0]), jnp.array([0.5])))
    assert not bool(both(jnp.array([-1.0]), jnp.array([0.5])))
    assert not bool(both(jnp.array([5.0]), jnp.array([2.0])))


def test_occupancy_grid():
    occ = np.zeros((10, 10), np.uint8)
    occ[4:6, 7:9] = 1  # rows y=4..5, cols x=7..8
    grid = collision.OccupancyGrid(occ, origin=(0.0, 0.0), resolution=1.0)
    assert bool(grid.occupied(jnp.array([7.5, 4.5])))
    assert not bool(grid.occupied(jnp.array([2.0, 2.0])))
    # out of bounds -> occupied (conservative)
    assert bool(grid.occupied(jnp.array([-1.0, 5.0])))
    assert bool(grid.occupied(jnp.array([5.0, 99.0])))
    # feasibility predicate with footprint
    feas = grid.feasibility(footprint_radius=1.0)
    assert not bool(feas(jnp.array([6.5, 4.5]), None))  # ring touches block
    assert bool(feas(jnp.array([3.0, 2.0]), None))
    # batched occupancy
    pts = jnp.array([[7.5, 4.5], [2.0, 2.0], [-1.0, 0.0]])
    np.testing.assert_array_equal(np.asarray(grid.occupied(pts)),
                                  [True, False, True])

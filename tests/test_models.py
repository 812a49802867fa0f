"""Model zoo tests: dynamics sanity + planner end-to-end on each workload
(D2 car, D3 boat, D4 quadrotor; SURVEY.md section 2.2 / BASELINE.json configs).

CPU budgets are generous (max_time) but goal-biased problems typically solve in
a few rounds; tests assert plan validity, not wall-clock.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import lqrrt_jax
from lqrrt_jax.models import boat, car, quadrotor


def _plan(prob, wrap_dims, batch=64, cap=2048, max_time=30.0, seed=11,
          goal_bias=0.2):
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=max_time, printing=False,
        batch_size=batch, capacity=cap, nn_block=256, seed=seed,
        wrap_dims=wrap_dims, saturate=prob.get("saturate"))
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=goal_bias)
    return planner, reached


def _check_plan(prob, planner):
    assert planner.x_seq is not None and len(planner.x_seq) > 1
    feas = prob["constraints"].is_feasible
    bad = 0
    for x, u in zip(planner.x_seq[1:], planner.u_seq):
        bad += 0 if bool(feas(jnp.asarray(x), jnp.asarray(u))) else 1
    assert bad == 0, f"{bad} infeasible plan points"


def test_boat_dynamics_sane():
    x = jnp.zeros(6)
    u = jnp.array([boat.WRENCH_MAX[0], 0.0, 0.0])
    xd = boat.f(x, u)
    assert float(xd[3]) > 0  # surge accelerates forward
    # drag saturates speed: at high surge velocity accel drops
    xfast = jnp.zeros(6).at[3].set(5.0)
    assert float(boat.f(xfast, u)[3]) < float(xd[3])
    # heading rotates velocity into world frame
    xh = jnp.zeros(6).at[2].set(jnp.pi / 2).at[3].set(1.0)
    pd = boat.f(xh, jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(pd[:2]), [0.0, 1.0], atol=1e-6)


def test_boat_planner_reaches_goal():
    prob = boat.default_problem()
    planner, reached = _plan(prob, wrap_dims=(2,), batch=128, cap=4096,
                             goal_bias=[0.3, 0.3, 0.0, 0.0, 0.0, 0.0])
    assert reached, planner.stats
    _check_plan(prob, planner)
    e = np.abs(np.asarray(prob["goal"]) - planner.x_seq[-1])
    e[2] = abs(float(jnp.mod(e[2] + np.pi, 2 * np.pi) - np.pi))
    gb = np.asarray(prob["constraints"].goal_buffer)
    assert np.all(e <= gb + 0.2), f"end error {e}"


def test_car_dynamics_nonholonomic():
    # zero speed: no lateral motion possible
    xd = car.f(jnp.array([0.0, 0.0, 0.0, 0.0]), jnp.array([0.0, 0.5]))
    np.testing.assert_allclose(np.asarray(xd[:3]), 0.0, atol=1e-7)
    # forward at heading 0 moves +x
    xd = car.f(jnp.array([0.0, 0.0, 0.0, 2.0]), jnp.zeros(2))
    assert float(xd[0]) > 0 and abs(float(xd[1])) < 1e-6


def test_car_planner_reaches_goal():
    prob = car.default_problem()
    planner, reached = _plan(prob, wrap_dims=(2,), batch=64, cap=2048,
                             goal_bias=[0.3, 0.3, 0.0, 0.1])
    assert reached, planner.stats
    _check_plan(prob, planner)


def test_quadrotor_hover_equilibrium():
    x0 = jnp.zeros(12).at[2].set(2.0)
    # u = 0 is hover: the thrust channel is a deviation from m*g
    xd = quadrotor.f(x0, jnp.zeros(4))
    np.testing.assert_allclose(np.asarray(xd), 0.0, atol=1e-5)


def test_quadrotor_planner_reaches_goal():
    prob = quadrotor.default_problem()
    planner, reached = _plan(prob, wrap_dims=(5,), batch=48, cap=2048,
                             max_time=60.0,
                             goal_bias=[0.3, 0.3, 0.3] + [0.0] * 9)
    assert reached, planner.stats
    _check_plan(prob, planner)


def test_boat_grid_obstacle_model_matches_circles():
    """The rasterized occupancy grid must agree with the analytic circles on
    clearly-free and clearly-occupied probes (SURVEY.md D3 deployment
    feasibility)."""
    circ = boat.default_problem(obstacle_model="circles")
    grid = boat.default_problem(obstacle_model="grid")
    u = jnp.zeros(3)
    probes_free = [np.array([0, 0, 0, 0, 0, 0], np.float32),
                   np.array([40, 0, 0, 0, 0, 0], np.float32),
                   np.array([5, 5, 0, 0, 0, 0], np.float32)]
    probes_hit = [np.array([12, 3, 0, 0, 0, 0], np.float32),   # buoy center
                  np.array([18, -4, 0, 0, 0, 0], np.float32)]
    for p in probes_free:
        assert bool(circ["constraints"].is_feasible(jnp.asarray(p), u))
        assert bool(grid["constraints"].is_feasible(jnp.asarray(p), u))
    for p in probes_hit:
        assert not bool(circ["constraints"].is_feasible(jnp.asarray(p), u))
        assert not bool(grid["constraints"].is_feasible(jnp.asarray(p), u))


def test_boat_hard_problem_geometry():
    """The two-wall anytime-quality instance: straight
    line blocked by both walls; the offset openings are feasible."""
    prob = boat.hard_problem()
    feas = prob["constraints"].is_feasible
    u = jnp.zeros(3)

    def free(x, y):
        return bool(feas(jnp.asarray([x, y, 0, 0, 0, 0], jnp.float32), u))

    # straight line hits both walls
    assert not free(18.0, 0.0)
    assert not free(36.0, 0.0)
    # wall 1 passable above, wall 2 below
    assert free(18.0, 9.0)
    assert free(36.0, -9.0)
    # and each wall blocks its other side
    assert not free(18.0, -9.0)
    assert not free(36.0, 9.0)
    # start and goal are free
    assert free(float(prob["x0"][0]), float(prob["x0"][1]))
    assert free(float(prob["goal"][0]), float(prob["goal"][1]))

"""Golden parity tests: numpy oracle (sequential reference semantics) vs the
batched planner, tolerance-based (SURVEY.md section 4 item 2 and section 7
"order-dependence of RRT — use tolerance-based trajectory comparison")."""
import numpy as np
import scipy.linalg
import jax.numpy as jnp
import pytest

import lqrrt_jax
from lqrrt_jax.models import boat, double_integrator as di
from lqrrt_jax.oracle import numpy_planner as oracle


def test_numpy_boat_dynamics_matches_jax():
    """The oracle's independent boat model must agree with the jax model."""
    dyn_np, _ = oracle.boat_dynamics_factory()
    rng = np.random.default_rng(0)
    for _ in range(20):
        x = rng.uniform(-2, 2, 6)
        u = rng.uniform(-500, 500, 3)
        a = dyn_np(x, u, 0.05)
        b = np.asarray(boat.dynamics(jnp.asarray(x, jnp.float32),
                                     jnp.asarray(u, jnp.float32), 0.05))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_numpy_car_dynamics_matches_jax():
    from lqrrt_jax.models import car
    dyn_np, _, _ = oracle.car_dynamics_factory()
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = rng.uniform(-2, 2, 4)
        u = rng.uniform(-3, 3, 2)
        a = dyn_np(x, u, 0.05)
        b = np.asarray(car.dynamics(jnp.asarray(x, jnp.float32),
                                    jnp.asarray(u, jnp.float32), 0.05))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_numpy_quadrotor_dynamics_matches_jax():
    from lqrrt_jax.models import quadrotor as quad
    dyn_np, _, _ = oracle.quadrotor_dynamics_factory()
    rng = np.random.default_rng(2)
    for _ in range(20):
        x = rng.uniform(-0.5, 0.5, 12)
        u = rng.uniform(-0.4, 0.4, 4)
        a = dyn_np(x, u, 0.05)
        b = np.asarray(quad.dynamics(jnp.asarray(x, jnp.float32),
                                     jnp.asarray(u, jnp.float32), 0.05))
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


def test_scipy_relinearized_lqr_matches_jax_car():
    """The oracle's scipy CARE stack must agree with the jax batched-Riccati
    stack at sample linearization points (disjoint solver paths, same math)."""
    from lqrrt_jax.models import car
    _, _, f_np = oracle.car_dynamics_factory()
    Q = np.diag([1.0, 1.0, 0.5, 0.3]); R = np.diag([0.5, 2.0])

    def x_map(x):
        v = x[3]
        x = x.copy()
        x[3] = np.where(abs(v) < 0.8, -0.8 if v < 0 else 0.8, v)
        return x

    lqr_np = oracle.make_scipy_relinearized_lqr(
        f_np, Q, R, u_eq=np.zeros(2), x_map=x_map)
    lqr_jx = car.make_lqr()
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.uniform(-2, 2, 4)
        S_np, K_np = lqr_np(x, None)
        S_jx, K_jx = lqr_jx(jnp.asarray(x, jnp.float32), None)
        np.testing.assert_allclose(S_np, np.asarray(S_jx), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(K_np, np.asarray(K_jx), rtol=2e-2,
                                   atol=2e-2)


def _di_oracle():
    A = np.zeros((4, 4)); A[0, 2] = A[1, 3] = 1.0
    B = np.zeros((4, 2)); B[2, 0] = B[3, 1] = 1.0
    Q = np.diag([1.0, 1.0, 0.3, 0.3]); R = 0.05 * np.eye(2)
    S = scipy.linalg.solve_continuous_are(A, B, Q, R)
    K = np.linalg.solve(R, B.T @ S)
    prob = di.default_problem()
    feas = oracle.make_circle_feasibility(*prob["obstacles"], margin=0.1)
    orc = oracle.NumpyOracle(
        dynamics=oracle.di_dynamics, lqr=lambda x, u: (S, K),
        erf=np.subtract, is_feasible=feas,
        goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"],
        saturate=lambda u: np.clip(u, -10, 10))
    return orc, prob


def test_oracle_di_reaches_goal():
    orc, prob = _di_oracle()
    reached, stats, plan = orc.plan(
        prob["x0"], prob["goal"], prob["sample_space"], goal_bias=0.15,
        seed=1, max_time=20.0)
    assert reached, stats
    assert stats["expansions_per_s"] > 0
    # plan endpoint in goal box
    e = np.abs(np.asarray(prob["goal"]) - plan[-1])
    assert np.all(e <= np.asarray(prob["constraints"].goal_buffer) + 1e-9)


def test_tpu_planner_matches_oracle_quality():
    """Both planners solve D1; the batched planner's plan duration is
    within 2x of the oracle's
    (tolerance-based golden comparison, SURVEY.md section 7)."""
    orc, prob = _di_oracle()
    reached_o, stats_o, plan_o = orc.plan(
        prob["x0"], prob["goal"], prob["sample_space"], goal_bias=0.15,
        seed=1, max_time=20.0)
    assert reached_o

    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=20.0, printing=False,
        batch_size=64, capacity=2048, nn_block=256, seed=5,
        saturate=prob["saturate"])
    reached_t = planner.update_plan(prob["x0"], prob["sample_space"],
                                    goal_bias=0.15)
    assert reached_t, planner.stats
    dur_o = stats_o["plan_duration_s"]
    dur_t = planner.T
    assert dur_t <= 2.0 * dur_o + 1.0, (
        f"batched plan {dur_t}s much worse than oracle {dur_o}s")


def test_oracle_goal_entry_truncation():
    """goal_entry_trunc=True stops every steer at its first in-goal step —
    the rollout that crosses the goal box ends inside it, matching the
    batched planner's fused goal stop (a truncation-matched oracle gives
    apples-to-apples quality ratios)."""
    orc, prob = _di_oracle()
    orc.goal_entry_trunc = True
    orc.is_feasible = lambda x, u: True       # clear workspace for the steer
    orc.horizon_steps = 400
    # velocity-tolerant goal box: a pass-through rollout carries speed, so
    # entry requires loose velocity bounds (like the boat's goal_buffer)
    orc.goal_buffer = np.array([0.3, 0.3, 50.0, 50.0])
    goal = np.array([1.0, 0.0, 0.0, 0.0])    # nearby goal on a clear line
    gb = orc.goal_buffer
    # steer THROUGH the goal: target far past it on the same line
    x0 = np.zeros(4)
    _, K = orc.lqr(x0, None)
    xtar = np.array([4.0, 0.0, 0.0, 0.0])
    xs, us, xnew = orc._steer(x0, K, xtar, goal)
    inside = np.all(np.abs(goal - xs) <= gb, axis=1)
    assert inside.any(), "rollout never entered the goal box"
    # truncated exactly at first entry: last step inside, none before it
    assert inside[-1]
    assert int(np.argmax(inside)) == len(xs) - 1
    # and the untruncated steer keeps going past the box
    xs2, _, _ = orc._steer(x0, K, xtar)
    assert len(xs2) > len(xs)

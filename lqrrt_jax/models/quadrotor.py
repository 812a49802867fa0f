"""12-state quadrotor — the D4 kinodynamic workload (BASELINE.json configs:
"Quadrotor 12-state kinodynamic planning with batched Riccati steering").

State  x = [p(3), rpy(3), v(3), w(3)]  (n = 12)
         world position, roll/pitch/yaw, world velocity, body angular rate
Control u = [dT, tx, ty, tz]            thrust DEVIATION from hover + torques

The thrust channel is parameterized about hover (total thrust = m g + dT) so
the framework's pure-feedback steering law u = K e is gravity-compensated at
zero error — the standard LQR formulation for hovering vehicles.  The LQR is
re-linearized about each node: the heaviest batched-CARE exercise in the
model zoo (24x24 Hamiltonian sign iterations under vmap).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import collision
from ..ops.angles import make_erf
from ..ops.integrate import discretize
from ..ops.riccati import make_relinearized_lqr

NSTATES = 12
NCONTROLS = 4

MASS = 1.0            # kg
G = 9.81
INERTIA = np.array([0.01, 0.01, 0.02], np.float32)   # diag body inertia
T_MAX = 25.0          # N, total thrust ceiling
TAU_MAX = 0.5         # N m
HOVER_T = MASS * G    # total thrust at hover; u[0] is the deviation from it


def _rpy_to_R(rpy):
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def f(x, u):
    rpy, v, w = x[3:6], x[6:9], x[9:12]
    T = jnp.clip(u[0] + HOVER_T, 0.0, T_MAX)
    tau = jnp.clip(u[1:], -TAU_MAX, TAU_MAX)
    R = _rpy_to_R(rpy)
    # Euler-angle rates from body rates (roll-pitch-yaw convention)
    r, p = rpy[0], rpy[1]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp = jnp.maximum(jnp.cos(p), 0.2)  # guard gimbal lock
    tp = jnp.sin(p) / cp
    E = jnp.array([[1.0, sr * tp, cr * tp],
                   [0.0, cr, -sr],
                   [0.0, sr / cp, cr / cp]])
    hi = jax.lax.Precision.HIGHEST      # float32, no TF32
    rpy_dot = jnp.dot(E, w, precision=hi)
    acc = (jnp.dot(R, jnp.stack([0.0 * T, 0.0 * T, T]), precision=hi) / MASS
           - np.array([0.0, 0.0, G], np.float32))
    w_dot = (tau - jnp.cross(w, INERTIA * w)) / INERTIA
    return jnp.concatenate([v, rpy_dot, acc, w_dot])


dynamics = discretize(f, "rk4")

erf = make_erf(NSTATES, angle_dims=(5,))  # yaw wraps; roll/pitch stay small

U_MIN = np.array([-HOVER_T, -TAU_MAX, -TAU_MAX, -TAU_MAX], np.float32)
U_MAX_VEC = np.array([T_MAX - HOVER_T, TAU_MAX, TAU_MAX, TAU_MAX],
                     np.float32)


def saturate(u):
    return jnp.clip(u, U_MIN, U_MAX_VEC)


def make_lqr(q=(1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 0.3, 0.3, 0.3, 0.1, 0.1, 0.1),
             r=(0.02, 2.0, 2.0, 2.0)):
    Q = np.diag(np.asarray(q, np.float32))
    R = np.diag(np.asarray(r, np.float32))
    return make_relinearized_lqr(f, Q, R,
                                 u_eq=np.zeros(NCONTROLS, np.float32))


def default_problem(obstacles: bool = True):
    """Fly 8 m through a column field at constant-ish altitude."""
    from ..constraints import Constraints

    centers = np.array([[3.0, 1.0], [5.0, -1.0], [6.5, 1.5]], np.float32)
    radii = np.array([0.8, 0.9, 0.7], np.float32)
    preds = [collision.control_limits(U_MIN, U_MAX_VEC)]
    if obstacles:
        preds.append(collision.circles_free(centers, radii, pos_dims=(0, 1),
                                            margin=0.3))
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([0.5, 0.5, 0.5, 0.4, 0.4, 0.5,
                              1.0, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32),
        search_buffer=np.array([[-1.0, 1.0]] * 3 + [[-0.4, 0.4]] * 3 +
                               [[-1.5, 1.5]] * 3 + [[-1.0, 1.0]] * 3, np.float32),
        is_feasible=collision.all_of(*preds))
    x0 = np.zeros(12, np.float32); x0[2] = 2.0
    goal = np.zeros(12, np.float32); goal[0] = 8.0; goal[2] = 2.0
    sample_space = np.array(
        [[-1.0, 9.0], [-3.0, 3.0], [1.0, 3.0],
         [-0.5, 0.5], [-0.5, 0.5], [-np.pi, np.pi],
         [-2.0, 2.0], [-2.0, 2.0], [-1.0, 1.0],
         [-1.5, 1.5], [-1.5, 1.5], [-1.0, 1.0]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=3.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=(5,))

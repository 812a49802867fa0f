"""Navigator WAM-V style 3-DOF surface vessel — the D3 headline workload.

State  x = [px, py, psi, vx, vy, w]   (n = 6)
         world position, heading, body-frame surge/sway velocity, yaw rate
Control u = [Fx, Fy, Mz]  body-frame wrench  (m = 3)

Mirrors the reference's boat demo structure (SURVEY.md D3: body-frame
rigid-body dynamics with mass/inertia matrix + drag, rotation of body
velocities into world frame, wrench saturation, psi-wrapping erf).  Parameters
are plausible WAM-V-class constants chosen for this framework's demo — the
reference mount was empty, so exact reference values are unverifiable
(SURVEY.md provenance warning).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..ops import collision
from ..ops.angles import make_erf
from ..ops.integrate import discretize
from ..ops.riccati import lqr_setup

NSTATES = 6
NCONTROLS = 3

# Rigid-body + added-mass parameters (WAM-V-class catamaran)
M_MASS = 350.0        # kg, incl. added mass (surge)
M_SWAY = 400.0        # kg, incl. added mass (sway)
I_YAW = 400.0         # kg m^2, incl. added inertia
# Drag: linear + quadratic, per DOF.  All constants are numpy: model modules
# must never commit device buffers at import (see ops/angles.make_erf note).
D_LIN = np.array([30.0, 60.0, 60.0], np.float32)
D_QUAD = np.array([60.0, 120.0, 120.0], np.float32)
# Wrench limits (two azimuthing thrusters-ish envelope)
WRENCH_MAX = np.array([600.0, 300.0, 600.0], np.float32)

_Minv = np.array([1.0 / M_MASS, 1.0 / M_SWAY, 1.0 / I_YAW], np.float32)


def f(x, u):
    """Continuous 3-DOF vessel dynamics, body-frame velocities."""
    psi = x[2]
    nu = x[3:]                     # [vx, vy, w] body frame
    c, s = jnp.cos(psi), jnp.sin(psi)
    # kinematics: world-frame pose rates
    pdot = jnp.stack([c * nu[0] - s * nu[1],
                      s * nu[0] + c * nu[1],
                      nu[2]])
    # Coriolis-ish coupling for a surface vessel (m * cross terms)
    cor = jnp.stack([M_SWAY * nu[1] * nu[2],
                     -M_MASS * nu[0] * nu[2],
                     (M_MASS - M_SWAY) * nu[0] * nu[1]])
    drag = D_LIN * nu + D_QUAD * nu * jnp.abs(nu)
    nudot = _Minv * (u + cor - drag)
    return jnp.concatenate([pdot, nudot])


def saturate(u):
    return jnp.clip(u, -WRENCH_MAX, WRENCH_MAX)


def f_saturated(x, u):
    """Dynamics with actuator saturation baked in (SURVEY.md C5: effort
    saturation is the user's job inside dynamics)."""
    return f(x, saturate(u))


dynamics = discretize(f_saturated, "rk4")

erf = make_erf(NSTATES, angle_dims=(2,))  # psi wraps (SURVEY.md D3)


def make_lqr(q=(1.0, 1.0, 2.0, 0.1, 0.1, 0.2), r=(2e-5, 2e-5, 2e-5)):
    """Constant LQR linearized about rest, the reference-demo pattern
    (CARE solved once up front; SURVEY.md section 0)."""
    x_eq = np.zeros(NSTATES, np.float32)
    x_eq[3] = 0.1  # slight surge for observability
    S, K = lqr_setup(f, x_eq, np.zeros(NCONTROLS, np.float32),
                     np.diag(np.asarray(q, np.float32)),
                     np.diag(np.asarray(r, np.float32)))
    S, K = jnp.asarray(S), jnp.asarray(K)

    def lqr(x, u):
        del x, u
        return S, K

    return lqr


def default_problem(obstacles: bool = True, obstacle_model: str = "circles",
                    grid_resolution: float = 0.25):
    """Benchmark scenario: 40 m transit through a buoy field.

    obstacle_model: "circles" (the reference-demo model) or "grid" — the same
    buoy field rasterized into an OccupancyGrid, the deployment-grade
    feasibility the WAM-V ran with (SURVEY.md D3: "occupancy-grid
    (deployment) feasibility").
    """
    from ..constraints import Constraints

    centers = np.array([[12.0, 3.0], [18.0, -4.0], [25.0, 2.0], [30.0, -3.0],
                        [8.0, -6.0], [22.0, 8.0], [34.0, 4.0]], np.float32)
    radii = np.array([2.5, 3.0, 2.0, 2.5, 2.0, 2.5, 2.0], np.float32)
    preds = []
    if obstacles and obstacle_model == "circles":
        preds.append(collision.circles_free(centers, radii, margin=1.0))
    elif obstacles and obstacle_model == "grid":
        origin = np.array([-4.0, -12.0], np.float32)
        W = int(round((46.0 - origin[0]) / grid_resolution))
        H = int(round((12.0 - origin[1]) / grid_resolution))
        gx = origin[0] + (np.arange(W) + 0.5) * grid_resolution
        gy = origin[1] + (np.arange(H) + 0.5) * grid_resolution
        X, Y = np.meshgrid(gx, gy)                       # (H, W)
        occ = np.zeros((H, W), bool)
        for c, r in zip(centers, radii):
            occ |= (X - c[0]) ** 2 + (Y - c[1]) ** 2 <= (r + 1.0) ** 2
        grid = collision.OccupancyGrid(occ, origin, grid_resolution)
        preds.append(grid.feasibility(footprint_radius=0.0))
    elif obstacles:
        raise ValueError(f"unknown obstacle_model {obstacle_model!r}")
    is_feasible = collision.all_of(*preds) if preds else (lambda x, u: jnp.bool_(True))
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([1.5, 1.5, 0.3, 0.8, 0.8, 0.5], np.float32),
        search_buffer=np.array([[-5.0, 5.0], [-5.0, 5.0], [-np.pi, np.pi],
                                [-1.0, 2.0], [-0.5, 0.5], [-0.5, 0.5]], np.float32),
        is_feasible=is_feasible)
    x0 = np.zeros(6, np.float32)
    goal = np.array([40.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-2.0, 44.0], [-10.0, 10.0], [-np.pi, np.pi],
         [0.0, 3.0], [-0.5, 0.5], [-0.7, 0.7]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=5.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=(2,))


def hard_problem():
    """Anytime-quality scenario: a 56 m transit through two walls of buoys
    with OFFSET gaps (wall 1 passable near y=+8, wall 2 near y=-8), so the
    straight line is blocked and competing homotopies differ by several
    seconds of trajectory time.  On ``default_problem`` the anytime curve
    saturates ~1% above the instance optimum within 0.2 s (all seeds
    converge to 16.75 s by 15 s of budget); this
    instance leaves real headroom for budget to buy quality, which is what
    the quality-vs-budget artifact and the informed-restart mechanism are
    measured on.
    """
    from ..constraints import Constraints

    rows = []
    # wall 1 at x=18 spans the bottom of the arena: passable only ABOVE
    # y ~ +7; wall 2 at x=36 spans the top: passable only BELOW y ~ -7
    for y in (-12.0, -8.0, -4.0, 0.0, 4.0):
        rows.append([18.0, y])
    for y in (-4.0, 0.0, 4.0, 8.0, 12.0):
        rows.append([36.0, y])
    centers = np.asarray(rows, np.float32)
    radii = np.full((len(rows),), 2.2, np.float32)
    is_feasible = collision.circles_free(centers, radii, margin=1.0)
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([1.5, 1.5, 0.3, 0.8, 0.8, 0.5], np.float32),
        search_buffer=np.array([[-5.0, 5.0], [-5.0, 5.0], [-np.pi, np.pi],
                                [-1.0, 2.0], [-0.5, 0.5], [-0.5, 0.5]],
                               np.float32),
        is_feasible=is_feasible)
    x0 = np.zeros(6, np.float32)
    goal = np.array([52.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-2.0, 56.0], [-15.0, 15.0], [-np.pi, np.pi],
         [0.0, 3.0], [-0.5, 0.5], [-0.7, 0.7]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=5.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=(2,))

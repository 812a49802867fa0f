"""Riccati solvers vs scipy ground truth (SURVEY.md section 4 test strategy)."""
import numpy as np
import pytest
import scipy.linalg

import jax
import jax.numpy as jnp

from lqrrt_jax.ops import riccati


def _random_system(key, n, m, stable_shift=0.0):
    rng = np.random.default_rng(key)
    A = rng.standard_normal((n, n)).astype(np.float32) - stable_shift * np.eye(n, dtype=np.float32)
    B = rng.standard_normal((n, m)).astype(np.float32)
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32)
    return A, B, Q, R


@pytest.mark.parametrize("n,m,seed", [(2, 1, 0), (4, 2, 1), (6, 3, 2), (12, 4, 3)])
def test_care_matches_scipy(n, m, seed):
    A, B, Q, R = _random_system(seed, n, m)
    P_scipy = scipy.linalg.solve_continuous_are(A, B, Q, R)
    P = np.asarray(riccati.solve_care(jnp.array(A), jnp.array(B), jnp.array(Q), jnp.array(R)))
    np.testing.assert_allclose(P, P_scipy, rtol=2e-3, atol=2e-3)


def test_care_double_integrator():
    # 2D double integrator: the D1 demo's LQR (SURVEY.md D1).
    A = np.zeros((4, 4), np.float32); A[0, 2] = A[1, 3] = 1.0
    B = np.zeros((4, 2), np.float32); B[2, 0] = B[3, 1] = 1.0
    Q = np.diag([1, 1, 0.1, 0.1]).astype(np.float32)
    R = 0.1 * np.eye(2, dtype=np.float32)
    P_scipy = scipy.linalg.solve_continuous_are(A, B, Q, R)
    P = np.asarray(riccati.solve_care(jnp.array(A), jnp.array(B), jnp.array(Q), jnp.array(R)))
    np.testing.assert_allclose(P, P_scipy, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,m,seed", [(4, 2, 10), (6, 3, 11)])
def test_dare_matches_scipy(n, m, seed):
    rng = np.random.default_rng(seed)
    # scale down A so the DARE is comfortably solvable
    A = (0.5 * rng.standard_normal((n, n))).astype(np.float32)
    B = rng.standard_normal((n, m)).astype(np.float32)
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32)
    P_scipy = scipy.linalg.solve_discrete_are(A, B, Q, R)
    P = np.asarray(riccati.solve_dare(jnp.array(A), jnp.array(B), jnp.array(Q), jnp.array(R)))
    np.testing.assert_allclose(P, P_scipy, rtol=2e-3, atol=2e-3)


def test_care_vmap_batched():
    """The whole point: CARE must solve under vmap (per-node batched Riccati)."""
    systems = [_random_system(s, 6, 3) for s in range(4)]
    A = jnp.stack([jnp.array(s[0]) for s in systems])
    B = jnp.stack([jnp.array(s[1]) for s in systems])
    Q = jnp.stack([jnp.array(s[2]) for s in systems])
    R = jnp.stack([jnp.array(s[3]) for s in systems])
    P_batch = jax.vmap(riccati.solve_care)(A, B, Q, R)
    for i, (a, b, q, r) in enumerate(systems):
        P_scipy = scipy.linalg.solve_continuous_are(a, b, q, r)
        np.testing.assert_allclose(np.asarray(P_batch[i]), P_scipy, rtol=2e-3, atol=2e-3)


def test_care_lqr_gain_stabilizes():
    A, B, Q, R = _random_system(42, 6, 3)
    S, K = riccati.care_lqr(jnp.array(A), jnp.array(B), jnp.array(Q), jnp.array(R))
    eig = np.linalg.eigvals(np.asarray(A) - np.asarray(B) @ np.asarray(K))
    assert np.all(eig.real < 0), f"closed loop unstable: {eig}"


def test_linearize_double_integrator():
    def f(x, u):
        return jnp.concatenate([x[2:], u])
    A, B = riccati.linearize(f, jnp.zeros(4), jnp.zeros(2))
    A_true = np.zeros((4, 4)); A_true[0, 2] = A_true[1, 3] = 1.0
    B_true = np.zeros((4, 2)); B_true[2, 0] = B_true[3, 1] = 1.0
    np.testing.assert_allclose(np.asarray(A), A_true, atol=1e-6)
    np.testing.assert_allclose(np.asarray(B), B_true, atol=1e-6)

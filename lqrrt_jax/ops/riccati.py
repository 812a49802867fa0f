"""Batched Riccati / CARE / DARE solvers and LQR policy construction.

In the reference, solving the continuous algebraic Riccati equation is the
*user's* job: the demos call ``scipy.linalg.solve_continuous_are`` and hand the
resulting ``(S, K)`` to the planner via the ``lqr(x, u)`` callback
(SURVEY.md section 0 and C5).  Here we promote the Riccati solve to a
first-class, batched, jit-able framework component so that re-linearized LQR
policies can be computed for thousands of tree nodes per expansion round
(BASELINE.json north_star: "solves the per-node LQR (CARE/Riccati iteration)
... as vmapped kernels").

Algorithms (all fixed iteration count -> static shapes, safe under jit/vmap):

* ``solve_care`` - matrix sign-function iteration on the Hamiltonian matrix
  with determinant scaling.  Quadratically convergent; 2n x 2n inverses only
  (n <= 12 for every shipped model), trivially batched with vmap.
* ``solve_dare`` - structure-preserving doubling algorithm (SDA).
* ``care_lqr`` / ``dare_lqr`` - convenience wrappers returning ``(S, K)`` in
  the reference's lqr-callback format.
* ``linearize`` - continuous-time (A, B) Jacobians of a dynamics model at
  (x, u), via jax.jacfwd.
* ``make_constant_lqr`` / ``make_relinearized_lqr`` - factories producing the
  ``lqr(x, u) -> (S, K)`` user callback (SURVEY.md L0) either precomputed
  (LTI, like the reference demos) or re-solved at every node (nonlinear).
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# Quadratic convergence reaches fp32 machine-eps in ~8-12 iterations with
# determinant scaling; 16 keeps margin for stiff systems.
_SIGN_ITERS = 16


def inv_logdet_gj(Z: Array) -> Tuple[Array, Array]:
    """Batched (inverse, log|det|) via Gauss-Jordan with IMPLICIT partial
    pivoting — the LU-free small-matrix inverse this framework uses inside
    every Riccati iteration.

    It uses only elementwise ops and single-row gathers, so its cost does
    not depend on how a backend lowers batched small LU factorizations.
    Whether ``jnp.linalg`` (cuSOLVER's batched solvers) is faster on the GPU
    is not measured yet.

    Implicit pivoting: each elimination step picks the largest remaining
    pivot in the column (classic partial-pivoting stability) but never
    permutes rows; the left half of the augmented system ends as a
    permutation matrix, undone by ONE row gather at the end.

    Z: (..., d, d) -> (Zinv (..., d, d), log|det| (...,)).
    """
    d = Z.shape[-1]
    batch = Z.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=Z.dtype), Z.shape)
    A = jnp.concatenate([Z, eye], axis=-1)          # (..., d, 2d)
    logdet = jnp.zeros(batch, Z.dtype)
    used = jnp.zeros(batch + (d,), bool)
    perm = jnp.zeros(batch + (d,), jnp.int32)
    idx = jnp.arange(d)

    def step(k, carry):
        A, logdet, used, perm = carry
        colk = jax.lax.dynamic_index_in_dim(A, k, axis=-1, keepdims=False)
        cand = jnp.where(used, -1.0, jnp.abs(colk))
        p = jnp.argmax(cand, axis=-1)               # per-batch pivot row
        used = used | (idx == p[..., None])
        perm = jax.lax.dynamic_update_index_in_dim(perm, p, k, axis=-1)
        prow = jnp.take_along_axis(A, p[..., None, None], axis=-2)[..., 0, :]
        piv = jnp.take_along_axis(colk, p[..., None], axis=-1)[..., 0]
        logdet = logdet + jnp.log(jnp.abs(piv) + 1e-38)
        # Singular-input guard (mirrors the 1e-38 logdet floor): an exactly
        # singular Z would divide by 0 here and propagate silent NaN/Inf
        # through solve_care/solve_dare; flooring the pivot magnitude keeps
        # the result finite-but-large, detectable with jnp.isfinite by
        # callers handing in untrusted (e.g. degenerate-R) inputs.
        piv = jnp.where(jnp.abs(piv) < 1e-30,
                        jnp.where(piv < 0, -1e-30, 1e-30), piv)
        nrow = prow / piv[..., None]
        colk_m = jnp.where(idx == p[..., None], 0.0, colk)
        A = A - colk_m[..., :, None] * nrow[..., None, :]
        A = jnp.where((idx == p[..., None])[..., None],
                      nrow[..., None, :], A)
        return A, logdet, used, perm

    A, logdet, used, perm = jax.lax.fori_loop(0, d, step,
                                              (A, logdet, used, perm))
    Zinv = jnp.take_along_axis(A[..., :, d:], perm[..., :, None], axis=-2)
    return Zinv, logdet


def inv_gj(Z: Array) -> Array:
    """Batched LU-free inverse (see inv_logdet_gj)."""
    return inv_logdet_gj(Z)[0]


def _matrix_sign(H: Array, iters: int = _SIGN_ITERS) -> Array:
    """Matrix sign function via scaled Newton iteration Z <- (cZ + (cZ)^-1)/2.

    Determinant scaling c = |det Z|^(-1/dim) accelerates early convergence;
    both the inverse and log|det| come from ONE Gauss-Jordan elimination per
    iteration (inv_logdet_gj — LU-free by design, see its docstring).
    Fixed trip count keeps the loop jit-friendly (SURVEY.md section 7,
    "compiler-friendly control flow").
    """
    dim = H.shape[-1]

    def body(Z, _):
        Zi, logdet = inv_logdet_gj(Z)
        # |det Z|^(-1/dim); clamp to avoid inf/0 scale blowups on
        # near-singular iterates.
        c = jnp.exp(jnp.clip(-logdet / dim, -20.0, 20.0))
        if Z.ndim > 2:
            c = c[..., None, None]
        Zn = 0.5 * (c * Z + Zi / c)
        return Zn, None

    Z, _ = jax.lax.scan(body, H, None, length=iters)
    return Z


def _mm(a, b):
    """Full-fp32 matmul (no TF32) via the per-op precision attribute."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def solve_care(A: Array, B: Array, Q: Array, R: Array) -> Array:
    """Solve A'P + PA - P B R^-1 B' P + Q = 0 for the stabilizing P.

    Matrix-sign method: build the Hamiltonian H = [[A, -G], [-Q, -A']] with
    G = B R^-1 B'; the stable invariant subspace of H is the graph of P, and
    sign(H) acts as -I on it.  Writing sign(H) = [[S11, S12], [S21, S22]],
    every stable vector [x; Px] satisfies (S11 + I) x + S12 P x = 0 and
    S21 x + (S22 + I) P x = 0, so P solves the stacked least-squares system
    [S12; S22 + I] P = -[S11 + I; S21].

    Batched over leading axes with vmap.  Replaces the reference demos' use of
    scipy.linalg.solve_continuous_are (SURVEY.md section 0).  Linear solves
    are inv-based and matmuls carry per-op HIGHEST precision (n <= 12,
    well-conditioned inputs: inv+matmul is accurate here).

    R must be nonsingular and (A, B) stabilizable / (A, Q) detectable —
    the standard CARE requirements.  Degenerate inputs return finite-but-
    meaningless values (the Gauss-Jordan pivot is magnitude-floored, never
    NaN/Inf); validate with jnp.isfinite + a residual check if inputs are
    untrusted.
    """
    n = A.shape[-1]
    G = _mm(_mm(B, inv_gj(R)), B.T)
    H = jnp.block([[A, -G], [-Q, -A.T]])
    S = _matrix_sign(H)
    S11, S12 = S[:n, :n], S[:n, n:]
    S21, S22 = S[n:, :n], S[n:, n:]
    I = jnp.eye(n, dtype=A.dtype)
    M = jnp.concatenate([S12, S22 + I], axis=0)         # (2n, n)
    rhs = -jnp.concatenate([S11 + I, S21], axis=0)      # (2n, n)
    # Normal equations: M is well-conditioned for stabilizable/detectable
    # systems, and n is tiny, so this is both fast and accurate enough.
    P = _mm(inv_gj(_mm(M.T, M)), _mm(M.T, rhs))
    return 0.5 * (P + P.T)  # symmetrize


_DOUBLING_ITERS = 30


def solve_dare(A: Array, B: Array, Q: Array, R: Array) -> Array:
    """Solve A'PA - P - A'PB (R + B'PB)^-1 B'PA + Q = 0 (discrete CARE).

    Structure-preserving doubling algorithm (SDA):
        A_{k+1} = A_k (I + G_k H_k)^-1 A_k
        G_{k+1} = G_k + A_k (I + G_k H_k)^-1 G_k A_k'
        H_{k+1} = H_k + A_k' H_k (I + G_k H_k)^-1 A_k
    with A_0 = A, G_0 = B R^-1 B', H_0 = Q; H_k -> P quadratically.
    inv-based solves + per-op HIGHEST matmuls — see _mm.
    """
    n = A.shape[-1]
    I = jnp.eye(n, dtype=A.dtype)
    G0 = _mm(_mm(B, inv_gj(R)), B.T)

    def body(carry, _):
        Ak, Gk, Hk = carry
        W = inv_gj(I + _mm(Gk, Hk))
        An = _mm(_mm(Ak, W), Ak)
        Gn = Gk + _mm(_mm(_mm(Ak, W), Gk), Ak.T)
        Hn = Hk + _mm(_mm(_mm(Ak.T, Hk), W), Ak)
        return (An, Gn, Hn), None

    init = jax.lax.optimization_barrier((A, G0, jnp.broadcast_to(Q, A.shape)))
    (_, _, H), _ = jax.lax.scan(body, init, None, length=_DOUBLING_ITERS)
    return 0.5 * (H + H.T)


def care_lqr(A: Array, B: Array, Q: Array, R: Array) -> Tuple[Array, Array]:
    """Continuous-time LQR: returns (S, K) with K = R^-1 B' S.

    Matches the (S, K) contract of the reference's lqr(x, u) callback
    (SURVEY.md section 0: "S = cost-to-go matrix, K = feedback gain").
    """
    S = solve_care(A, B, Q, R)
    K = _mm(inv_gj(R), _mm(B.T, S))
    return S, K


def dare_lqr(A: Array, B: Array, Q: Array, R: Array) -> Tuple[Array, Array]:
    """Discrete-time LQR: returns (S, K) with K = (R + B'SB)^-1 B'SA."""
    S = solve_dare(A, B, Q, R)
    K = _mm(inv_gj(R + _mm(_mm(B.T, S), B)), _mm(_mm(B.T, S), A))
    return S, K


def linearize(f: Callable, x: Array, u: Array) -> Tuple[Array, Array]:
    """Continuous-time Jacobians A = df/dx, B = df/du at (x, u)."""
    A = jax.jacfwd(f, argnums=0)(x, u)
    B = jax.jacfwd(f, argnums=1)(x, u)
    return A, B


def _cpu_device():
    """CPU device for setup-time solves, or None if unavailable.

    Setup-time CARE is host work by design: run it on the CPU backend and
    let jit move the resulting (S, K) constants to the accelerator.
    """
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def care_lqr_host(A, B, Q, R) -> Tuple[Array, Array]:
    """Eager (setup-time) CARE + gain on the CPU backend.

    Inputs stay host numpy until inside the CPU-device scope: a jnp.asarray
    outside it would commit each operand to the default backend, and the
    CPU jit would then copy them back.
    """
    import numpy as _np
    dev = _cpu_device()
    args = [_np.asarray(x, _np.float32) for x in (A, B, Q, R)]
    if dev is None:
        return care_lqr(*[jnp.asarray(a) for a in args])
    with jax.default_device(dev):
        S, K = jax.jit(care_lqr)(*args)
        return jax.device_get(S), jax.device_get(K)


def lqr_setup(f: Callable, x_eq, u_eq, Q, R) -> Tuple[Array, Array]:
    """Setup-time linearize + CARE + gain, compiled as ONE program on CPU.

    Eager jacfwd + sign iteration would dispatch hundreds of tiny ops; one
    jitted CPU program runs them as a single executable.
    """
    import numpy as _np
    dev = _cpu_device()
    # numpy args: stay on the host until the CPU scope (see care_lqr_host)
    args = [_np.asarray(v, _np.float32) for v in (x_eq, u_eq, Q, R)]

    def prog(x, u, Q, R):
        A, B = linearize(f, x, u)
        return care_lqr(A, B, Q, R)

    if dev is None:
        return prog(*[jnp.asarray(a) for a in args])
    with jax.default_device(dev):
        S, K = jax.jit(prog)(*args)
        return jax.device_get(S), jax.device_get(K)


def make_constant_lqr(A: Array, B: Array, Q: Array, R: Array) -> Callable:
    """Precompute one (S, K) and return an lqr(x, u) callback that serves it.

    This is the LTI pattern of the reference demos: CARE solved once up front,
    every node shares the same policy (SURVEY.md D1/D3 notes).
    """
    S, K = care_lqr_host(A, B, Q, R)
    S, K = jnp.asarray(S), jnp.asarray(K)

    def lqr(x, u):
        del x, u
        return S, K

    return lqr


def make_relinearized_lqr(f: Callable, Q: Array, R: Array,
                          u_eq: Array | None = None,
                          x_map: Callable | None = None) -> Callable:
    """Return an lqr(x, u) callback that re-linearizes f and re-solves CARE.

    Fully traceable, so the planner can vmap it over every freshly committed
    node in an expansion round (the "batched Riccati" component of
    BASELINE.json's north star).  ``u_eq`` optionally fixes the control
    linearization point (e.g. hover thrust for the quadrotor).

    ``x_map`` optionally transforms the state into the linearization *point*
    (e.g. flooring a speed so a kinematic car stays stabilizable at rest).
    Crucially the map is applied outside the differentiation — the Jacobians
    are taken of f itself at x_map(x), so no couplings are zeroed out the way
    a clamp inside f would zero them.
    """
    Q = jnp.asarray(Q, jnp.float32)
    R = jnp.asarray(R, jnp.float32)

    def lqr(x, u):
        xlin = x if x_map is None else x_map(x)
        ulin = u if u_eq is None else jnp.asarray(u_eq, jnp.float32)
        A, B = linearize(f, xlin, ulin)
        return care_lqr(A, B, Q, R)

    return lqr

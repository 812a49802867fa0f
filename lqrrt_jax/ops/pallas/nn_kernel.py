"""Fused LQR-metric nearest neighbour: Pallas through Triton.

Reference: Planner._nearest scans the whole node array for the minimizer of
e' S e with e = erf(x_node, xrand) (SURVEY.md C4).  The plain version
(core/nearest.py) materialises (B, block, n) error and S e tensors per node
block; at the boat's bench shapes (B = 8192 candidates, N = 40960 rows) that
is hundreds of MB of device-memory traffic per round.  This kernel keeps the
(candidate tile x node block) cost plane in registers and only ever reads the
node features (about 1 MB for the whole tree) and writes one (id, cost) pair
per candidate.

Layout: each program owns ``block_b`` candidates and walks the live node
blocks with a ``lax.fori_loop`` whose trip count is ``cdiv(size, block_n)``,
so blocks past the live prefix are never read.  Node and candidate features
are stored feature-major ((F, N) and (F, B)), so every load is one contiguous
power-of-two vector.  The running (min, argmin) stays in registers: each
(candidate, lane) slot keeps its own minimum across blocks, and the
cross-lane (min, argmin) runs once per candidate after the loop; ties go to
the lowest node index, as in the plain version.  Rows at or past ``size``
are masked by their index, so stale values there (NaN or -inf included) can
never win.

One kernel, two metric forms (static switch ``const_metric``):

* constant metric (one S for the whole tree, the boat): with S = L L' the
  cost is the exact whitened distance ||L'(x_j - r_b)||^2, evaluated as
  direct differences of the pre-whitened coordinates z = x L, w = r L.
  A wrapped angle dim a shifts the error by -2 pi k u_a with
  k = round((x_a - r_a) / 2 pi), which in whitened coordinates subtracts
  k * 2 pi L[a, :] from the difference.
* per-node metric (the car and quadrotor re-linearise S at every node):
  e = x_j - r_b with the angle dim wrapped, and e' S_j e from the
  n(n+1)/2 upper-triangle coefficients of the node's symmetrised S.

Precision: every operation is an elementwise float32 multiply or add on the
CUDA cores.  There is no matrix product, so no TF32 and no cancelling
expansion of the quadratic; the costs agree with the plain f32 reference to
float32 rounding.

Only one wrapped dim is supported (every shipped model has at most one);
other erfs use core/nearest.py.  ``interpret=True`` runs the same kernel
through the Pallas interpreter on the CPU, which is how the tests check it.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_TWO_PI = 2.0 * np.pi
_INV_TWO_PI = 1.0 / _TWO_PI
_INF = float(np.inf)       # python scalar: kernels cannot capture arrays


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _nn_kernel(size_ref, node_ref, cand_ref, coef_ref, cost_ref, idx_ref, *,
               n: int, wrap_dim, const_metric: bool, block_b: int,
               block_n: int):
    """One program: ``block_b`` candidates against every live node block.

    node_ref: (F, Np) node features, feature-major.  Constant metric: rows
              [0, n) whitened z, row n the raw angle x_a.  Per-node metric:
              rows [0, n) states, then the n(n+1)/2 S coefficients.
    cand_ref: (n + 1, Bp) candidate features: whitened w or raw r in rows
              [0, n), raw angle r_a in row n (constant metric only).
    coef_ref: (C,) constant metric: 2 pi L[a, :] (zero-padded).
    cost_ref / idx_ref: (Bp,) best cost and node id per candidate.
    """
    rows = pl.ds(pl.program_id(0) * block_b, block_b)
    cand = [cand_ref[d, rows][:, None] for d in range(n)]    # (bt, 1) each
    wrapped = wrap_dim is not None
    if const_metric and wrapped:
        r_a = cand_ref[n, rows][:, None]
        shift = [coef_ref[d] for d in range(n)]
    size = size_ref[0]

    def pair_cost(cols):
        x = [node_ref[d, cols][None, :] for d in range(n)]   # (1, blk) each
        if const_metric:
            if wrapped:
                k = jnp.floor((node_ref[n, cols][None, :] - r_a)
                              * _INV_TWO_PI + 0.5)
            acc = None
            for d in range(n):
                diff = x[d] - cand[d]
                if wrapped:
                    diff = diff - k * shift[d]
                acc = diff * diff if acc is None else acc + diff * diff
            return acc
        e = [x[d] - cand[d] for d in range(n)]               # (bt, blk) each
        if wrapped:
            ea = e[wrap_dim]
            e[wrap_dim] = ea - _TWO_PI * jnp.floor(ea * _INV_TWO_PI + 0.5)
        acc = None
        t = n
        for c in range(n):
            inner = None
            for d in range(c, n):
                w = node_ref[t, cols][None, :]
                t += 1
                inner = w * e[d] if inner is None else inner + w * e[d]
            term = e[c] * inner
            acc = term if acc is None else acc + term
        return acc

    def body(j, carry):
        # elementwise running best over node blocks: each (candidate, lane)
        # slot keeps the first minimum it sees (strict <), so the one
        # cross-lane reduction happens once, after the loop
        best_c, best_i = carry
        start = j * block_n
        c = pair_cost(pl.ds(start, block_n))
        idx = start + jax.lax.broadcasted_iota(jnp.int32, (1, block_n), 1)
        c = jnp.where(idx < size, c, _INF)
        take = c < best_c
        return jnp.where(take, c, best_c), jnp.where(take, idx, best_i)

    init = (jnp.full((block_b, block_n), _INF, jnp.float32),
            jnp.zeros((block_b, block_n), jnp.int32))
    n_blocks = (size + block_n - 1) // block_n
    best_c, best_i = jax.lax.fori_loop(0, n_blocks, body, init)
    # lowest node id among the slots that hold the minimum
    bc = jnp.min(best_c, axis=1)
    bi = jnp.min(jnp.where(best_c == bc[:, None], best_i, jnp.int32(2**30)),
                 axis=1)
    cost_ref[rows] = bc
    idx_ref[rows] = jnp.where(bi == 2**30, 0, bi)


def _pad_cols(a, mult: int):
    pad = -a.shape[-1] % mult
    return a if pad == 0 else jnp.pad(a, ((0, 0), (0, pad)))


def _tiles(n: int, const_metric: bool):
    """(block_b, block_n, num_warps) measured fastest on an H100 at the
    planner's shapes (PERF.md)."""
    if const_metric:
        return 8, 128, 4
    return (8, 64, 2) if n <= 6 else (8, 128, 4)


@functools.partial(jax.jit, static_argnames=(
    "wrap_dim", "const_metric", "interpret"))
def nearest_pallas(states, S, size, xrand, *, wrap_dim: int | None = None,
                   const_metric: bool = False, interpret: bool = False):
    """Fused nearest(states, S, size, xrand) -> (ids, costs).

    states: (N, n); S: (N, n, n) (only S[0] is read when ``const_metric``,
    so every live node must share it; a single (n, n) S is accepted too);
    size: () int, live rows are [0, size); xrand: (B, n).  Any N and B:
    both are padded to whole tiles, and padded rows are masked.
    ``wrap_dim``: optional single angle dim, wrapped exactly per pair.
    """
    N, n = states.shape
    B = xrand.shape[0]
    if wrap_dim is not None and not 0 <= wrap_dim < n:
        raise ValueError(f"wrap_dim {wrap_dim} out of range for n={n}")
    block_b, block_n, num_warps = _tiles(n, const_metric)
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    states = states.astype(f32)
    xrand = xrand.astype(f32)
    if const_metric:
        S0 = (S[0] if S.ndim == 3 else S).astype(f32)
        S0 = 0.5 * (S0 + S0.T)
        # tiny jitter keeps the factor defined for merely PSD matrices
        L = jnp.linalg.cholesky(S0 + 1e-9 * jnp.eye(n, dtype=f32))
        node = [jnp.dot(states, L, precision=hi).T]           # (n, N)
        cand = [jnp.dot(xrand, L, precision=hi).T]            # (n, B)
        if wrap_dim is not None:
            node.append(states[None, :, wrap_dim])
            cand.append(xrand[None, :, wrap_dim])
            coef = _TWO_PI * L[wrap_dim]
        else:
            coef = jnp.zeros((n,), f32)
    else:
        iu, ju = np.triu_indices(n)
        Ssum = S + jnp.swapaxes(S, 1, 2)
        coefs = jnp.where(jnp.asarray(iu == ju), S[:, iu, ju],
                          Ssum[:, iu, ju])                   # (N, T)
        node = [states.T, coefs.astype(f32).T]
        cand = [xrand.T]
        coef = jnp.zeros((n,), f32)
    node = _pad_cols(jnp.concatenate(node, axis=0), block_n)
    cand = _pad_cols(jnp.concatenate(cand, axis=0), block_b)
    coef = jnp.pad(coef, (0, _next_pow2(n) - n))
    Bp = cand.shape[1]

    kernel = functools.partial(
        _nn_kernel, n=n, wrap_dim=wrap_dim, const_metric=const_metric,
        block_b=block_b, block_n=block_n)
    cost, idx = pl.pallas_call(
        kernel,
        grid=(Bp // block_b,),
        out_shape=(jax.ShapeDtypeStruct((Bp,), f32),
                   jax.ShapeDtypeStruct((Bp,), jnp.int32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="lqr_nearest_const" if const_metric else "lqr_nearest",
    )(jnp.asarray(size, jnp.int32).reshape(1), node, cand, coef)
    return idx[:B], cost[:B]


def make_nearest_pallas(wrap_dim: int | None = None,
                        const_metric: bool = False,
                        interpret: bool = False):
    """Adapter matching core.nearest.make_nearest's return signature."""
    def nearest(states, S, size, xrand):
        return nearest_pallas(states, S, size, xrand, wrap_dim=wrap_dim,
                              const_metric=const_metric,
                              interpret=interpret)
    return nearest

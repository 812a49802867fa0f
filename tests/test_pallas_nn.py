"""Fused Triton-route NN kernel vs the jnp blocked-scan path (interpret mode).

The kernel (ops/pallas/nn_kernel.py) evaluates the LQR metric per pair in
float32 on the CUDA cores; through the Pallas interpreter on the CPU it must
reproduce the argmin of core.nearest exactly and its costs to float32
rounding, in both metric forms (constant S whitened, per-node S), with the
wrapped angle dim, across several candidate tiles and ragged shapes
(SURVEY.md section 4 test strategy: "argmin-NN vs brute force").
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lqrrt_jax.core.nearest import make_nearest
from lqrrt_jax.ops.angles import make_erf
from lqrrt_jax.ops.pallas.nn_kernel import nearest_pallas

N, n, B = 256, 6, 16


def _random_tree(seed, wrap_dim=None, nn=n, NN=N, BB=B):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-5, 5, (NN, nn)).astype(np.float32)
    if wrap_dim is not None:
        states[:, wrap_dim] = rng.uniform(-np.pi, np.pi, NN)
    A = rng.normal(size=(NN, nn, nn)).astype(np.float32)
    S = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(nn, dtype=np.float32)
    xrand = rng.uniform(-5, 5, (BB, nn)).astype(np.float32)
    if wrap_dim is not None:
        xrand[:, wrap_dim] = rng.uniform(-np.pi, np.pi, BB)
    return jnp.asarray(states), jnp.asarray(S), jnp.asarray(xrand)


def _check(states, S, size, xrand, wrap_dim, const_metric):
    nn = states.shape[1]
    erf = make_erf(nn, angle_dims=(wrap_dim,) if wrap_dim is not None
                   else ())
    ids_ref, cost_ref = make_nearest(erf, block=states.shape[0])(
        states, S, jnp.asarray(size), xrand)
    ids, cost = nearest_pallas(states, S, jnp.asarray(size), xrand,
                               wrap_dim=wrap_dim, const_metric=const_metric,
                               interpret=True)
    np.testing.assert_allclose(np.asarray(cost), np.asarray(cost_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))


@pytest.mark.parametrize("size", [1, 7, N])
def test_pallas_matches_jnp_affine(size):
    """Per-node form, plain subtract erf, live prefixes of 1, 7 and N."""
    states, S, xrand = _random_tree(0)
    _check(states, S, size, xrand, None, False)


def test_pallas_matches_jnp_wrapped():
    states, S, xrand = _random_tree(1, wrap_dim=2)
    _check(states, S, N, xrand, 2, False)


def test_pallas_per_node_n12_wrapped():
    """The quadrotor's width: n = 12, per-node S, wrapped yaw (dim 5)."""
    states, S, xrand = _random_tree(11, wrap_dim=5, nn=12, NN=200, BB=24)
    _check(states, S, 173, xrand, 5, False)


def _seam_case():
    states = np.zeros((8, n), np.float32)
    states[0, 2] = np.pi - 0.05          # just below the seam
    states[1, 2] = 1.0                   # far in angle
    S = np.tile(np.eye(n, dtype=np.float32), (8, 1, 1))
    xrand = np.zeros((8, n), np.float32)
    xrand[:, 2] = -np.pi + 0.05          # just above the seam
    return jnp.asarray(states), jnp.asarray(S), jnp.asarray(xrand)


def test_wrap_selection_prefers_short_way_around():
    """A node just across the -pi/pi seam must be 'near' under the metric
    (per-node form)."""
    states, S, xrand = _seam_case()
    ids, cost = nearest_pallas(states, S, jnp.asarray(2), xrand,
                               wrap_dim=2, interpret=True)
    assert int(ids[0]) == 0              # 0.1 rad around the seam beats 1 rad
    np.testing.assert_allclose(float(cost[0]), 0.1 ** 2, rtol=1e-3)


def test_planner_pallas_impl_runs_end_to_end():
    """nn_impl='pallas' (interpret on CPU) plans the double integrator."""
    from lqrrt_jax.models import double_integrator as di
    import lqrrt_jax

    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=512, nn_block=128,
        saturate=prob.get("saturate"), nn_impl="pallas", seed=3)
    # generous budget: planning ends deterministically at the capacity cap
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.2, specific_time=60.0)
    assert reached
    assert planner.nn_selected == "pallas_const"
    assert planner.x_seq.shape[1] == prob["constraints"].nstates


def _const_S_tree(seed, wrap_dim=None):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-5, 5, (N, n)).astype(np.float32)
    A = rng.normal(size=(n, n)).astype(np.float32)
    S1 = (A @ A.T + 0.1 * np.eye(n)).astype(np.float32)
    S = np.tile(S1, (N, 1, 1))
    xrand = rng.uniform(-5, 5, (B, n)).astype(np.float32)
    if wrap_dim is not None:
        states[:, wrap_dim] = rng.uniform(-np.pi, np.pi, N)
        xrand[:, wrap_dim] = rng.uniform(-np.pi, np.pi, B)
    return jnp.asarray(states), jnp.asarray(S), jnp.asarray(xrand)


@pytest.mark.parametrize("size", [1, 7, N])
@pytest.mark.parametrize("wrap_dim", [None, 2])
def test_pallas_const_matches_jnp(size, wrap_dim):
    """The constant-S whitened-distance form vs the general jnp path."""
    states, S, xrand = _const_S_tree(7, wrap_dim=wrap_dim)
    _check(states, S, size, xrand, wrap_dim, True)


def test_pallas_const_wrap_seam():
    states, S, xrand = _seam_case()
    ids, cost = nearest_pallas(states, S, jnp.asarray(2), xrand,
                               wrap_dim=2, const_metric=True,
                               interpret=True)
    assert int(ids[0]) == 0
    np.testing.assert_allclose(float(cost[0]), 0.1 ** 2, rtol=1e-3)


def test_planner_autodetects_constant_lqr():
    """nn_impl='pallas' takes its form from the lqr probe: a constant lqr
    selects the whitened constant-metric form, the re-linearised car lqr
    the per-node form."""
    from lqrrt_jax.models import car, double_integrator as di
    import lqrrt_jax

    prob = di.default_problem()
    p1 = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=32, capacity=512, nn_block=128,
        nn_impl="pallas", seed=5)
    reached = p1.update_plan(prob["x0"], prob["sample_space"],
                             goal_bias=0.2, specific_time=60.0)
    assert reached and p1.nn_selected == "pallas_const"
    assert p1._lqr_is_constant()

    cprob = car.default_problem()
    p2 = lqrrt_jax.Planner(
        cprob["dynamics"], cprob["lqr"], cprob["constraints"],
        horizon=cprob["horizon"], dt=cprob["dt"], goal0=cprob["goal"],
        printing=False, batch_size=8, capacity=128, nn_block=128,
        wrap_dims=cprob["wrap_dims"], erf=cprob["erf"],
        saturate=cprob.get("saturate"), nn_impl="pallas", seed=5)
    assert not p2._lqr_is_constant()
    p2._nearest_override()
    assert p2.nn_selected == "pallas"


def _multi_tile(const_metric):
    rng = np.random.default_rng(4)
    N2, B2 = 300, 203
    states = jnp.asarray(rng.uniform(-3, 3, (N2, n)).astype(np.float32))
    A = rng.normal(size=(N2, n, n)).astype(np.float32)
    S = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(n, dtype=np.float32)
    if const_metric:
        S = np.broadcast_to(S[:1], S.shape)
    xr = jnp.asarray(rng.uniform(-3, 3, (B2, n)).astype(np.float32))
    _check(states, jnp.asarray(S), N2, xr, None, const_metric)


def test_pallas_multi_tile_candidates():
    """Many candidate tiles, with B and N not multiples of the tiles: the
    wrapper pads both and the padded rows never win (per-node form)."""
    _multi_tile(False)


def test_pallas_const_multi_tile_candidates():
    _multi_tile(True)


@pytest.mark.parametrize("const_metric", [False, True])
def test_stale_nonfinite_rows_never_win(const_metric):
    """Rows at or past ``size`` may hold anything (stale commits, NaN,
    -inf); the kernel masks them by index, so they never win."""
    states, S, xrand = (_const_S_tree(3) if const_metric
                        else _random_tree(3))
    size = 100
    poisoned = np.asarray(states).copy()
    poisoned[size:] = np.nan
    poisoned[size::3] = -np.inf
    poisoned[size + 1] = np.asarray(xrand)[0]     # an exact stale match
    ids, cost = nearest_pallas(jnp.asarray(poisoned), S, jnp.asarray(size),
                               xrand, const_metric=const_metric,
                               interpret=True)
    ids_ref, _ = make_nearest(make_erf(n), block=N)(
        states, S, jnp.asarray(size), xrand)
    assert np.all(np.asarray(ids) < size)
    assert np.all(np.isfinite(np.asarray(cost)))
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))


def _planner_for_override(monkeypatch, platform, nn_impl="auto"):
    from lqrrt_jax.models import boat
    import lqrrt_jax

    prob = boat.default_problem()
    p = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=16, capacity=128, nn_block=128,
        wrap_dims=prob["wrap_dims"], nn_impl=nn_impl)
    p._lqr_is_constant()            # probe on the real backend first
    if platform is not None:
        class _Dev:
            pass
        dev = _Dev()
        dev.platform = platform
        monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
    return p


def test_auto_picks_jnp_on_cpu(monkeypatch):
    p = _planner_for_override(monkeypatch, None)
    assert jax.devices()[0].platform == "cpu"
    assert p._nearest_override() is None
    assert p.nn_selected == "jnp"


def test_auto_picks_compiled_kernel_on_gpu(monkeypatch):
    """On a GPU, "auto" selects the kernel compiled for the card (never the
    interpreter); the boat's constant lqr selects the constant form."""
    from lqrrt_jax.ops.pallas import nn_kernel

    seen = {}

    def fake_make(**kw):
        seen.update(kw)
        return "kernel"

    monkeypatch.setattr(nn_kernel, "make_nearest_pallas", fake_make)
    p = _planner_for_override(monkeypatch, "gpu")
    assert p._nearest_override() == "kernel"
    assert p.nn_selected == "pallas_const"
    assert seen == dict(wrap_dim=None, const_metric=True, interpret=False)


def test_forced_pallas_refuses_other_platforms(monkeypatch):
    p = _planner_for_override(monkeypatch, "metal", nn_impl="pallas")
    with pytest.raises(ValueError, match="runs on a GPU"):
        p._nearest_override()


def test_nn_impl_validation():
    from lqrrt_jax.models import double_integrator as di
    import lqrrt_jax

    prob = di.default_problem()
    with pytest.raises(ValueError, match="unknown nn_impl"):
        lqrrt_jax.Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                          horizon=prob["horizon"], nn_impl="pallas_const")

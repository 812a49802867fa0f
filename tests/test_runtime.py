"""Native trajectory server: query parity with the Python planner path and
torn-read-freedom under a concurrent publisher (SURVEY.md sections 3.3, 5.2)."""
import threading

import numpy as np
import pytest

pytest.importorskip("ctypes")

try:
    from lqrrt_jax.runtime import TrajectoryServer
    _ts = TrajectoryServer(2, 1, cap_steps=16)  # probe: compiles the .so
    NATIVE = True
except Exception:  # pragma: no cover - no C compiler in env
    NATIVE = False

pytestmark = pytest.mark.skipif(not NATIVE, reason="no C toolchain")


def _plan(P, n, m, seed=0, dt=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, n)).astype(np.float32),
            rng.normal(size=(P - 1, m)).astype(np.float32), dt)


def test_query_parity_with_python_interp():
    n, m, dt = 3, 2, 0.05
    x, u, _ = _plan(40, n, m, dt=dt)
    ts = TrajectoryServer(n, m, cap_steps=64)
    ts.publish(x, u, dt)
    assert abs(ts.T - dt * 39) < 1e-9
    for t in (-1.0, 0.0, 0.024, 0.31, 1.234, dt * 39, 99.0):
        tau = np.clip(t / dt, 0, len(x) - 1)
        i = int(np.floor(tau))
        j = min(i + 1, len(x) - 1)
        a = tau - i
        ref_x = (1 - a) * x[i] + a * x[j]
        np.testing.assert_allclose(ts.get_state(t), ref_x, rtol=1e-6,
                                   atol=1e-6)
        tau_u = np.clip(t / dt, 0, len(u) - 1)
        ki = int(np.floor(tau_u))
        kj = min(ki + 1, len(u) - 1)
        ka = tau_u - ki
        ref_u = (1 - ka) * u[ki] + ka * u[kj]
        np.testing.assert_allclose(ts.get_effort(t), ref_u, rtol=1e-6,
                                   atol=1e-6)


def test_capacity_and_unpublished_errors():
    ts = TrajectoryServer(2, 1, cap_steps=8)
    with pytest.raises(RuntimeError, match="no plan"):
        ts.get_state(0.0)
    x, u, dt = _plan(9, 2, 1)
    with pytest.raises(ValueError, match="exceeds capacity"):
        ts.publish(x, u, dt)


def test_no_torn_reads_under_concurrent_publish():
    """Readers must always see a plan whose rows are internally consistent.
    Each published plan is constant-valued (plan k is all-k), so any mixed
    row would expose a torn read."""
    n, m, P = 4, 2, 64
    ts = TrajectoryServer(n, m, cap_steps=P)
    ts.publish(np.zeros((P, n), np.float32), np.zeros((P - 1, m), np.float32),
               0.05)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            s = ts.get_state(1.3)
            if not np.all(s == s[0]):
                errors.append(s.copy())
            e = ts.get_effort(0.7)
            if not np.all(e == e[0]):
                errors.append(e.copy())

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for th in threads:
        th.start()
    for k in range(1, 2000):
        v = float(k)
        ts.publish(np.full((P, n), v, np.float32),
                   np.full((P - 1, m), v, np.float32), 0.05)
    stop.set()
    for th in threads:
        th.join()
    assert not errors, errors[:3]


def test_attach_planner_publishes_on_replan():
    import lqrrt_jax
    from lqrrt_jax.models import double_integrator as di
    from lqrrt_jax.utils import BufferSink, attach

    prob = di.default_problem()
    planner = lqrrt_jax.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        min_time=0.0, max_time=5.0, printing=False, batch_size=32,
        capacity=256, nn_block=128, seed=2)
    buf = BufferSink()
    attach(planner, buf)                    # metrics hook first...
    ts = TrajectoryServer(4, 2).attach(planner)   # ...server composes over it
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=1.0, pruning=False)
    np.testing.assert_allclose(ts.get_state(0.5), planner.get_state(0.5),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.get_effort(0.5), planner.get_effort(0.5),
                               rtol=1e-6, atol=1e-6)
    assert abs(ts.T - planner.T) < 1e-6
    assert len(buf.records) == 1            # composed hook still fired

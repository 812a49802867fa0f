"""Constraints record behavior (reference lqrrt/constraints.py, SURVEY.md C9)."""
import numpy as np
import pytest

from lqrrt_jax.constraints import Constraints


def _c(**kw):
    base = dict(nstates=4, ncontrols=2, goal_buffer=[1, 1, 0.5, 0.5],
                search_buffer=[[-2, 3], [-2, 3], [-1, 1], [-1, 1]])
    base.update(kw)
    return Constraints(**base)


def test_sample_space_spans_x0_goal_padded_by_search_buffer():
    c = _c()
    x0 = np.array([0.0, 5.0, 0.0, 0.0])
    goal = np.array([10.0, -5.0, 0.0, 0.0])
    ss = c.sample_space(x0, goal)
    assert ss.shape == (4, 2)
    np.testing.assert_allclose(ss[0], [0 - 2, 10 + 3])     # min(x0,goal)+lo
    np.testing.assert_allclose(ss[1], [-5 - 2, 5 + 3])     # order-agnostic
    np.testing.assert_allclose(ss[2], [-1, 1])
    assert np.all(ss[:, 0] <= ss[:, 1])


def test_goal_buffer_shape_validated():
    with pytest.raises(ValueError):
        Constraints(nstates=4, ncontrols=2, goal_buffer=[1, 1])


def test_feasibility_swap_bumps_version():
    c = _c()
    v0 = c._feasibility_version
    c.set_feasibility_function(lambda x, u: True)
    assert c._feasibility_version == v0 + 1
    with pytest.raises(ValueError):
        c.set_feasibility_function("not callable")

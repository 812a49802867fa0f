"""The ``lqrrt`` drop-in shim serves the framework under the reference's
import name (reference lqrrt/__init__.py re-exports, SURVEY.md section 1)."""
import numpy as np

import lqrrt
import lqrrt_jax


def test_shim_reexports_framework_classes():
    assert lqrrt.Planner is lqrrt_jax.Planner
    assert lqrrt.Tree is lqrrt_jax.Tree
    assert lqrrt.Constraints is lqrrt_jax.Constraints
    assert lqrrt.__all__ == ["Planner", "Tree", "Constraints"]


def test_shim_plans_end_to_end():
    """A reference-style user program against ``import lqrrt`` runs whole."""
    from lqrrt_jax.models import double_integrator as di

    prob = di.default_problem()
    planner = lqrrt.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        printing=False, batch_size=64, capacity=512, rounds_per_chunk=2)
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=0.3, specific_time=2.0)
    assert planner.x_seq is not None and len(planner.x_seq) >= 1
    state = planner.get_state(0.0)
    assert np.allclose(state, np.asarray(prob["x0"]), atol=1e-5)
    assert isinstance(reached, bool)

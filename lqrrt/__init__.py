"""Drop-in compatibility shim: ``import lqrrt`` serves the JAX framework.

The reference package is imported as ``lqrrt`` and re-exports Planner, Tree,
Constraints from its __init__ (SURVEY.md section 1, lqrrt/__init__.py).  A
reference user switching to this framework can keep their imports unchanged —
``lqrrt.Planner`` / ``lqrrt.Tree`` / ``lqrrt.Constraints`` are the lqrrt_jax
classes, whose constructor and method surfaces mirror the reference 1:1
(PARITY.md C1-C13).

The one behavioral delta is inherited from the batched re-architecture: user
callbacks (dynamics, lqr, erf, is_feasible, xrand_gen) must be jax-traceable
rather than arbitrary numpy code, since the framework vmaps them across the
candidate batch on device.
"""
from lqrrt_jax import Constraints, Planner, Tree
from lqrrt_jax import __version__

__all__ = ["Planner", "Tree", "Constraints"]

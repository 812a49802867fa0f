"""lqrrt_jax — a batched kinodynamic RRT planning framework in JAX.

A from-scratch JAX/XLA/Pallas re-architecture with the capabilities of the
reference lqRRT planner (jnez71/lqRRT): LQR as both the nearest-neighbor
metric and the steering policy, grown as batched expansion rounds on a
fixed-capacity device tree instead of a sequential Python loop.

Public surface mirrors the reference package (SURVEY.md section 1:
lqrrt/__init__.py re-exports Planner, Tree, Constraints).
"""
from .constraints import Constraints
from .planner import Planner
from .tree import Tree

__all__ = ["Planner", "Tree", "Constraints"]
__version__ = "0.1.0"

"""Angle-wrapping utilities and erf (error-function) constructors.

The reference takes a user 'erf(xgoal, x)' callback whose job is subtraction
plus wrapping of angular state dims into [-pi, pi] (SURVEY.md L0 callbacks,
demo pattern section 3.5).  These helpers build jit/vmap-safe erfs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def wrap_angle(a):
    """Wrap angle(s) into [-pi, pi). Traceable, elementwise."""
    return jnp.mod(a + jnp.pi, TWO_PI) - jnp.pi


def make_erf(nstates: int, angle_dims: Sequence[int] = ()):
    """Build erf(xgoal, x) = xgoal - x with wrapping on ``angle_dims``.

    With no angle dims this reduces to the reference default ``np.subtract``
    (SURVEY.md C1: erf default).
    """
    if not angle_dims:
        def erf(xgoal, x):
            return xgoal - x
        erf.angle_dims = ()       # affine-erf tag: enables the Pallas NN path
        return erf
    # numpy constant: backend-neutral, commits no device buffer at import
    mask = np.zeros((nstates,), bool)
    mask[list(angle_dims)] = True

    def erf(xgoal, x):
        e = xgoal - x
        return jnp.where(mask, wrap_angle(e), e)

    erf.angle_dims = tuple(angle_dims)  # tag: enables the Pallas NN path
    return erf

"""CM polar-angle distributions.

Covers the reference's ``kinematics/angle.py``
(/root/reference/src/attpc_engine/kinematics/angle.py:6-152): uniform in
cos(theta), or an arbitrary binned pdf with in-bin smearing. Each provides
the batched device sampler ``sample_jax`` used by the pipeline in addition
to the reference-compatible scalar ``sample(rng)``.
"""

from __future__ import annotations

from typing import Protocol

import jax
import jax.numpy as jnp
import numpy as np
from numpy.random import Generator

__all__ = ["PolarDistribution", "PolarUniform", "PolarArbitrary"]


class PolarDistribution(Protocol):
    """Protocol for CM polar-angle distributions (domain [0, pi])."""

    def sample(self, rng: Generator) -> float:  # type: ignore[empty-body]
        ...

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:  # type: ignore[empty-body]
        ...


class PolarUniform:
    """Uniform in cos(theta) over [angle_min, angle_max] radians.

    Matches reference semantics (angle.py:62-80): samples
    arccos(U[cos(angle_max), cos(angle_min)]).
    """

    def __init__(self, angle_min: float, angle_max: float):
        self.cos_angle_min = np.cos(angle_max)
        self.cos_angle_max = np.cos(angle_min)

    def sample(self, rng: Generator) -> float:
        return float(np.arccos(rng.uniform(self.cos_angle_min, self.cos_angle_max)))

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:
        u = jax.random.uniform(
            key,
            shape,
            dtype=jnp.float64,
            minval=self.cos_angle_min,
            maxval=self.cos_angle_max,
        )
        return jnp.arccos(u)


class PolarArbitrary:
    """Arbitrary binned polar-angle pdf with in-bin smearing.

    Matches reference semantics (angle.py:122-152): pick a bin's *lower*
    angle with the given probabilities, add U[0,1) * bin_width.

    Unlike the reference (which warns of a runtime penalty for this class),
    the batched sampler is a single inverse-CDF gather — no penalty on device.
    """

    def __init__(
        self,
        angles: np.ndarray,
        probabilities: np.ndarray,
        angle_bin_width: float,
    ):
        # the reference's rng.choice(p=...) requires the probabilities to
        # sum to exactly 1 (within numpy's internal atol); silently
        # renormalizing a sum < 1 would be a hidden distribution divergence
        if abs(float(np.sum(probabilities)) - 1.0) > 1.0e-6:
            raise ValueError(
                "The sum of the probabilities passed to PolarArbitrary should be 1.0."
                f" Yours sum to {np.sum(probabilities)}"
            )
        self.angle_width = angle_bin_width
        self.probs = np.asarray(probabilities, dtype=np.float64)
        self.angles = np.asarray(angles, dtype=np.float64)
        cdf = np.cumsum(self.probs)
        self._cdf = cdf / cdf[-1]

    def sample(self, rng: Generator) -> float:
        angle = rng.choice(self.angles, p=self.probs)
        return float(angle + rng.uniform(0.0, 1.0) * self.angle_width)

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, shape, dtype=jnp.float64)
        idx = jnp.searchsorted(jnp.asarray(self._cdf), u, side="left")
        idx = jnp.clip(idx, 0, len(self.angles) - 1)
        base = jnp.asarray(self.angles)[idx]
        smear = jax.random.uniform(k2, shape, dtype=jnp.float64)
        return base + smear * self.angle_width

"""Excitation-energy distributions.

Covers the reference's ``kinematics/excitation.py``
(/root/reference/src/attpc_engine/kinematics/excitation.py:6-188): a
Protocol plus Gaussian, Uniform and relativistic Breit-Wigner samplers.

Batched design: every distribution provides ``sample_jax(key, shape)``
returning a device array — this is the path used by the batched pipeline —
in addition to the reference-compatible scalar ``sample(rng)``.

The relativistic Breit-Wigner (scipy-free) is sampled by inverse-CDF lookup
against a table built once at construction from the analytic pdf
    f(x; rho) = k / ((x^2 - rho^2)^2 + rho^2),   x >= 0
(the same distribution scipy.stats.rel_breitwigner implements, used by the
reference at excitation.py:186).
"""

from __future__ import annotations

from typing import Protocol

import jax
import jax.numpy as jnp
import numpy as np
from numpy.random import Generator

__all__ = [
    "ExcitationDistribution",
    "ExcitationGaussian",
    "ExcitationUniform",
    "ExcitationBreitWigner",
]


class ExcitationDistribution(Protocol):
    """Protocol for excited-state energy distributions."""

    def sample(self, rng: Generator) -> float:  # type: ignore[empty-body]
        """Sample one value with a numpy Generator (scalar API)."""
        ...

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:  # type: ignore[empty-body]
        """Sample a batch on device (used by the batched pipeline)."""
        ...


class ExcitationGaussian:
    """Gaussian excitation: ``centroid`` (MeV) and FWHM ``width`` (MeV).

    FWHM -> sigma conversion uses the same /2.355 factor as the reference
    (excitation.py:65).
    """

    def __init__(self, centroid: float = 0.0, width: float = 0.0):
        self.centroid = centroid
        self.width = width  # FWHM
        self.sigma = self.width / 2.355

    def sample(self, rng: Generator) -> float:
        return rng.normal(self.centroid, self.sigma)

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:
        return self.centroid + self.sigma * jax.random.normal(
            key, shape, dtype=jnp.float64
        )


class ExcitationUniform:
    """Uniform excitation over [min_value, max_value] (MeV)."""

    def __init__(self, min_value: float = 0.0, max_value: float = 0.0):
        self.min_value = min_value
        self.max_value = max_value

    def sample(self, rng: Generator) -> float:
        return rng.uniform(self.min_value, self.max_value)

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:
        return jax.random.uniform(
            key,
            shape,
            dtype=jnp.float64,
            minval=self.min_value,
            maxval=self.max_value,
        )


class ExcitationBreitWigner:
    """Relativistic Breit-Wigner excitation.

    Parameters
    ----------
    rest_mass: float
        Rest mass of the excited nucleus in MeV.
    centroid: float
        State centroid in MeV.
    width: float
        State width (Gamma) in MeV.

    Sampling matches the reference's use of scipy's ``rel_breitwigner``
    (excitation.py:185-188): the *total energy* (rest_mass + excitation) is
    drawn from rel-BW with shape ``rho = (rest_mass + centroid) / width`` and
    scale ``width``; the excitation is that minus the rest mass.

    Implementation: inverse-CDF interpolation over a dense table built once
    at construction (device-friendly; no scipy)."""

    _TABLE_SIZE = 16384

    def __init__(self, rest_mass: float, centroid: float, width: float):
        self.rest_mass = rest_mass
        self.centroid = centroid
        self.width = width
        self.rho = (rest_mass + centroid) / width
        self._build_table()

    def _build_table(self) -> None:
        rho = self.rho
        # Support: x >= 0 in units of the scale (width). Near the peak the
        # pdf is approximately Lorentzian in (x - rho) with half-width 1/2,
        # so a tan-warped grid x = rho + 0.5 tan(theta) places points with
        # roughly CDF-proportional density and captures the far tails
        # (a finite linear window would clip ~0.5% of the mass and bias the
        # sampled quantiles).
        eps = 2e-4
        theta = np.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, self._TABLE_SIZE)
        x = rho + 0.5 * np.tan(theta)
        x = np.unique(np.clip(x, 0.0, None))
        pdf = 1.0 / ((x**2 - rho**2) ** 2 + rho**2)
        cdf = np.concatenate(
            [[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5 * np.diff(x))]
        )
        cdf /= cdf[-1]
        # Deduplicate flat regions so interpolation is well-posed
        keep = np.concatenate([[True], np.diff(cdf) > 0])
        self._cdf = cdf[keep]
        self._x = x[keep]

    def sample(self, rng: Generator) -> float:
        u = rng.uniform(0.0, 1.0)
        x = float(np.interp(u, self._cdf, self._x))
        total_energy = x * self.width
        return total_energy - self.rest_mass

    def sample_jax(self, key: jax.Array, shape: tuple[int, ...]) -> jax.Array:
        u = jax.random.uniform(key, shape, dtype=jnp.float64)
        x = jnp.interp(u, jnp.asarray(self._cdf), jnp.asarray(self._x))
        return x * self.width - self.rest_mass

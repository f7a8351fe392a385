"""GET electronics response.

Matches the reference's theoretical GET chip response
(/root/reference/src/attpc_engine/detector/response.py:8-57), including the
``tbs = linspace(0, 512, 512)`` sampling quirk (response.py:26 — note this
is NOT 0..511; kept for output parity).

Batched: ``apply_response_batch`` evaluates amplitude/integral for a whole
batch of cloud points as one [n, 512] elementwise program instead of a
per-point Python/numba loop (reference response.py:35-57).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import NUM_TB, E_CHARGE

__all__ = ["get_response", "apply_response", "apply_response_batch"]


def get_response(config) -> np.ndarray:
    """Theoretical GET response sampled per time bucket.

    r(tb) = c1 * exp(-3 c2) * c2^3 * sin(c2), negatives clipped; c1 scales
    to ADC units from the amplifier gain (see
    https://doi.org/10.1016/j.nima.2016.09.018).
    """
    c1 = 4095 * E_CHARGE / config.elec_params.amp_gain / 1e-15
    tbs = np.linspace(0.0, NUM_TB, NUM_TB)
    c2 = tbs / (
        config.elec_params.shaping_time * config.elec_params.clock_freq * 0.001
    )
    response = c1 * np.exp(-3.0 * c2) * (c2**3) * np.sin(c2)
    response[response < 0] = 0
    return response


def apply_response(response: np.ndarray, electrons: float) -> tuple[float, float]:
    """Scalar amplitude/integral for one point (reference-compatible API).

    The response scaled by the electron count is clipped at the 11-bit ADC
    maximum (4095); amplitude is the max sample, integral the sum.
    """
    resp_sig = np.minimum(response * electrons, 4095.0)
    return (float(resp_sig.max()), float(resp_sig.sum()))


def apply_response_batch(
    response: jnp.ndarray, electrons: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched amplitude/integral.

    Parameters
    ----------
    response: [NUM_TB] response vector.
    electrons: [n] electron counts.

    Returns
    -------
    (amplitude [n], integral [n]) with per-sample 4095 ADC clipping.
    """
    sig = jnp.minimum(response[None, :] * electrons[:, None], 4095.0)
    return sig.max(axis=1), sig.sum(axis=1)

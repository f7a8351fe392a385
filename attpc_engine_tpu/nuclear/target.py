"""Target materials: ``GasTarget`` and the spyral-compatible JSON loader.

Fills the role of ``spyral_utils.nuclear.target`` in the reference engine
(imported at /root/reference/src/attpc_engine/kinematics/pipeline.py:5 and
detector/solver.py:6). API surface kept compatible:

- ``GasTarget(components, pressure_torr, nuclear_map)`` with components as
  ``[(Z, A, stoichiometry), ...]``,
- ``.density`` (g/cm^3), ``.get_dedx(nucleus, ke)`` (MeV cm^2/g),
- ``.get_energy_loss(nucleus, ke, distances_m)`` (MeV),
- ``load_target(path, nuclear_map)`` reading the spyral-utils JSON schema
  ``{"compound": [[Z, A, S], ...], "pressure(Torr)": P}``.

Batched: every per-projectile stopping curve is materialized once as a
log-spaced table; ``dedx_interp_arrays`` exposes the arrays the detector
integrator gathers from on device. All pointwise evaluation here is
host-side convenience built on the same tables, so device and host physics
agree exactly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from .masses import NucleusData, NuclearDataMap
from .stopping import build_dedx_table, build_range_table

__all__ = ["GasTarget", "SolidTarget", "load_target", "TargetData"]

# Ideal-gas molar volume parameters
_R_L_TORR = 62.36367  # L Torr / (K mol)
_ROOM_TEMP_K = 293.15  # K


@dataclass
class TargetData:
    """Parsed target JSON (spyral-utils schema)."""

    compound: list[tuple[int, int, int]]
    pressure: float | None = None  # Torr (gas)
    thickness: float | None = None  # ug/cm^2 (solid)


class GasTarget:
    """A gas target with ideal-gas density and table-backed stopping power.

    Parameters
    ----------
    components: list[tuple[int, int, int]]
        (Z, A, stoichiometry) per molecular constituent, e.g. deuterium gas
        D2 = ``[(1, 2, 2)]`` (reference usage: tests/test_detector.py:13).
    pressure_torr: float
        Gas pressure in Torr.
    nuclear_data: NuclearDataMap
        Nuclide lookup.
    temperature_k: float
        Gas temperature for the ideal-gas density (default 293.15 K).
    """

    def __init__(
        self,
        components: list[tuple[int, int, int]],
        pressure_torr: float,
        nuclear_data: NuclearDataMap,
        temperature_k: float = _ROOM_TEMP_K,
    ):
        self.components = [(int(z), int(a), int(s)) for z, a, s in components]
        self.pressure = pressure_torr
        self.temperature = temperature_k
        self.nuclear_data = nuclear_data
        self.data = TargetData(compound=self.components, pressure=pressure_torr)

        # molar mass (g/mol) with integer A as the nucleon-count approximation
        self.molar_mass = float(sum(a * s for _, a, s in self.components))
        # ideal gas density in g/cm^3
        self.density = (
            self.pressure * self.molar_mass / (_R_L_TORR * self.temperature) / 1000.0
        )

        # mass fractions per constituent element
        self._constituents = [
            (z, a, a * s / self.molar_mass) for z, a, s in self.components
        ]

        self.ugly_string = "".join(
            f"{self.nuclear_data.get_data(z, a).isotopic_symbol}{s}"
            for z, a, s in self.components
        ) + f"@{self.pressure}Torr"

        # (Z, A) -> (log_ke, dedx, range) tables
        self._tables: dict[tuple[int, int], tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def __str__(self) -> str:
        return self.ugly_string

    # ------------------------------------------------------------------ #
    # tables                                                              #
    # ------------------------------------------------------------------ #

    def _get_tables(
        self, nucleus: NucleusData
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        key = (nucleus.Z, nucleus.A)
        cached = self._tables.get(key)
        if cached is not None:
            return cached
        log_ke, dedx = build_dedx_table(nucleus.Z, nucleus.mass, self._constituents)
        _, rng = build_range_table(log_ke, dedx)
        self._tables[key] = (log_ke, dedx, rng)
        return self._tables[key]

    def load_dedx_npz(self, path) -> int:
        """Load external stopping tables (e.g. a CATIMA export produced by
        ``tools/make_catima_tables.py``) for exact physics parity.

        The npz holds ``ke_mev [n]`` plus ``dedx_{Z}_{A} [n]`` arrays; every
        species present is installed via :meth:`set_custom_dedx`. Returns
        the number of species loaded."""
        from .masses import NuclearDataMap

        data = np.load(path)
        ke = data["ke_mev"]
        count = 0
        lookup = NuclearDataMap()
        for name in data.files:
            if not name.startswith("dedx_"):
                continue
            _, z, a = name.split("_")
            self.set_custom_dedx(lookup.get_data(int(z), int(a)), ke, data[name])
            count += 1
        return count

    def set_custom_dedx(
        self, nucleus: NucleusData, ke_mev: np.ndarray, dedx: np.ndarray
    ) -> None:
        """Override the stopping table for one projectile with external data
        (e.g. a CATIMA/SRIM export) for exact parity with other tools.

        ``ke_mev`` must be positive ascending; it is resampled onto the
        standard log grid."""
        log_ke_std, _ = build_dedx_table(nucleus.Z, nucleus.mass, self._constituents)
        dedx_std = np.interp(
            log_ke_std, np.log(np.asarray(ke_mev, dtype=np.float64)), dedx
        )
        _, rng = build_range_table(log_ke_std, dedx_std)
        self._tables[(nucleus.Z, nucleus.A)] = (log_ke_std, dedx_std, rng)

    def dedx_interp_arrays(
        self, nucleus: NucleusData
    ) -> tuple[np.ndarray, np.ndarray]:
        """(log_ke [n], dedx [n]) arrays for device-side jnp.interp."""
        log_ke, dedx, _ = self._get_tables(nucleus)
        return log_ke, dedx

    # ------------------------------------------------------------------ #
    # pointwise API (host-side, reference-compatible)                     #
    # ------------------------------------------------------------------ #

    def get_dedx(self, nucleus: NucleusData, kinetic_energy: float) -> float | np.ndarray:
        """Mass stopping power (MeV cm^2/g) at one or many KEs (MeV)."""
        log_ke, dedx, _ = self._get_tables(nucleus)
        ke = np.clip(np.asarray(kinetic_energy, dtype=np.float64), 1e-12, None)
        out = np.interp(np.log(ke), log_ke, dedx)
        return float(out) if np.isscalar(kinetic_energy) else out

    def get_energy_loss(
        self,
        nucleus: NucleusData,
        kinetic_energy: float,
        distances: np.ndarray,
    ) -> np.ndarray:
        """Energy lost (MeV) traversing ``distances`` meters of gas.

        Range-table inversion: E_out = R^-1(R(E_in) - rho * d); matches the
        reference's GasTarget.get_energy_loss contract
        (pipeline.py:256-263)."""
        log_ke, _, rng_tab = self._get_tables(nucleus)
        r0 = np.interp(np.log(max(kinetic_energy, 1e-12)), log_ke, rng_tab)
        x = np.asarray(distances, dtype=np.float64) * 100.0 * self.density  # g/cm^2
        r_out = np.clip(r0 - x, 0.0, None)
        # Invert R(E) in the same (log_ke <-> rng_tab) parameterization as the
        # forward lookup, so the x -> 0 round-trip is exact and small losses
        # are first-order accurate in the grid spacing.
        e_out = np.exp(np.interp(r_out, rng_tab, log_ke))
        e_out = np.where(r_out <= 0.0, 0.0, e_out)
        return kinetic_energy - e_out

    def get_range(self, nucleus: NucleusData, kinetic_energy: float) -> float:
        """CSDA range in meters of this gas at the given KE (MeV)."""
        log_ke, _, rng_tab = self._get_tables(nucleus)
        r = np.interp(np.log(max(kinetic_energy, 1e-12)), log_ke, rng_tab)
        return float(r / self.density / 100.0)


class SolidTarget:
    """A solid target (thickness in ug/cm^2). Provided for loader parity;
    the simulation stages use GasTarget."""

    def __init__(
        self,
        components: list[tuple[int, int, int]],
        thickness_ug_cm2: float,
        nuclear_data: NuclearDataMap,
    ):
        self.components = [(int(z), int(a), int(s)) for z, a, s in components]
        self.thickness = thickness_ug_cm2
        self.nuclear_data = nuclear_data
        self.data = TargetData(compound=self.components, thickness=thickness_ug_cm2)
        molar = float(sum(a * s for _, a, s in self.components))
        self._constituents = [(z, a, a * s / molar) for z, a, s in self.components]

    def get_dedx(self, nucleus: NucleusData, kinetic_energy: float) -> float:
        from .stopping import mass_stopping_power

        return float(
            mass_stopping_power(
                nucleus.Z, nucleus.mass, np.float64(kinetic_energy), self._constituents
            )
        )


def load_target(
    path: Path | str, nuclear_data: NuclearDataMap
) -> GasTarget | SolidTarget:
    """Load a target from a spyral-utils-schema JSON file.

    Gas target schema: ``{"compound": [[Z, A, S], ...], "pressure(Torr)": P}``
    (referenced by the reference docs, user_guide/getting_started.md:47-50).
    Solid target schema uses ``"thickness(ug/cm^2)"`` instead of pressure.
    """
    path = Path(path)
    with path.open("r") as f:
        raw: dict[str, Any] = json.load(f)
    compound = [tuple(entry) for entry in raw["compound"]]
    pressure = raw.get("pressure(Torr)", raw.get("pressure_torr"))
    thickness = raw.get("thickness(ug/cm^2)", raw.get("thickness_ug_cm2"))
    if pressure is not None:
        return GasTarget(compound, float(pressure), nuclear_data)
    if thickness is not None:
        return SolidTarget(compound, float(thickness), nuclear_data)
    raise ValueError(f"Target JSON {path} has neither pressure nor thickness")

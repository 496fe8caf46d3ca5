# Gas-solid fluid-film correlations on tensors: dimensionless numbers and
# transfer coefficients (port of rmt_tpu/props/film.py; reference:
# PyREMOT/docs/fluidFilm.py:15-145). Plain arithmetic, so each function
# takes tensors or numbers alike.

from __future__ import annotations

FROSSLING, ROSNER, GARNER_KEEY = 1, 2, 3


def reynolds(gas_density, superficial_velocity, particle_diameter, viscosity):
    return superficial_velocity * particle_diameter * gas_density / viscosity


def schmidt(gas_density, viscosity, diffusivity):
    return (viscosity / gas_density) / diffusivity


def prandtl(cp_molar, viscosity, thermal_conductivity, mw_mix):
    """cp [J/mol.K], mw [kg/mol]."""
    return (cp_molar / mw_mix) * viscosity / thermal_conductivity


def sherwood(sc, re, method: int = FROSSLING):
    if method == FROSSLING:
        return 2 + 1.1 * sc ** (1 / 3) * re**0.6
    if method == ROSNER:
        return sc**0.4 * (0.4 * re**0.5 + 0.2 * (re * (2 / 3)))
    return 0.94 * re**0.5 * sc ** (1 / 3)


def nusselt(pr, re):
    return 2 + 1.1 * pr**0.33 * re**0.6


def mass_transfer_coefficient(sh, diffusivity, particle_diameter):
    """[m/s]; characteristic length = particle radius."""
    return sh * diffusivity / (particle_diameter / 2)


def heat_transfer_coefficient(nu, thermal_conductivity, particle_diameter):
    """[J/m^2.s.K] for spherical particles."""
    return (nu / particle_diameter) * thermal_conductivity


def thermal_diffusivity(thermal_conductivity, gas_density, cp_molar, mw_mix):
    return thermal_conductivity / (gas_density * cp_molar / mw_mix)

"""Energy source substep (SubStep3), the subset the flagship reaches:
viscous heating, local beta cooling, the radiative correction factor and
the near-floor equilibrium (reference src/SourceEuler.cpp:496-536,
:632-654, :1018-1051). Surface/S-curve cooling, irradiation and the
Ziampras beta variants are not ported yet and raise."""

from __future__ import annotations

import torch

from ..params import Physics
from .common import Geom, azim_next, set_rows
from . import eos


def check_supported(phys: Physics) -> None:
    """Raise for every SubStep3 branch outside the ported subset."""
    unsupported = {
        "SurfaceCooling": phys.cooling_surface_enabled,
        "stellar irradiation (HeatingStar)": phys.heating_star,
        "S-curve cooling": phys.cooling_scurve_enabled,
        "CoolingBetaMethod": phys.cooling_beta_method != "no",
        "CoolingBetaReference": phys.cooling_beta_reference,
        "CoolingBetaModel": phys.cooling_beta_model,
        "CoolingBetaFloor": phys.cooling_beta_floor,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def viscous_heating(phys: Physics, g: Geom, sigma, nu, tau_rr, tau_pp,
                    tau_rp, div_v):
    """Q+ from viscous dissipation (reference src/SourceEuler.cpp:496-536);
    meaningful on rows 1..NR-2."""
    trp_up = torch.roll(tau_rp, -1, dims=0)
    trp4 = 0.25 * (tau_rp + trp_up + azim_next(tau_rp) + azim_next(trp_up))
    nu_sig = nu * sigma
    safe = torch.where(nu_sig != 0.0, 2.0 * nu_sig, torch.ones_like(nu_sig))
    qplus = 1.0 / safe * (tau_rr ** 2 + 2.0 * trp4 ** 2 + tau_pp ** 2)
    qplus = qplus + (2.0 / 9.0) * nu_sig * div_v ** 2
    return torch.where(nu != 0.0, qplus * phys.heating_viscous_factor,
                       torch.zeros_like(qplus))


def beta_inverse(phys: Physics, current_time):
    """1/beta with the optional ramp-up (reference src/SourceEuler.cpp:641-650)."""
    beta_inv = 1.0 / phys.cooling_beta
    if phys.cooling_beta_ramp_up > 0.0:
        ramp = 1.0 - torch.exp(
            -(2.0 * current_time / phys.cooling_beta_ramp_up) ** 2)
        return beta_inv * ramp
    return beta_inv


def substep3(phys: Physics, constants, g: Geom, sigma, energy, nu,
             tau_rr, tau_pp, tau_rp, div_v, scale_height, current_time, dt):
    """Energy update with Q+ / Q- (reference src/SourceEuler.cpp:956-1051).
    Returns (energy_new, qplus, qminus); the Q grids are divided by the
    radiative correction factor and zero on the ghost rings."""
    check_supported(phys)
    nr = g.nrad
    qminus = torch.zeros_like(energy)
    if phys.cooling_beta_enabled:
        omega_k = torch.sqrt(constants.G * phys.hydro_center_mass
                             / g.rb ** 3)
        qminus = qminus + energy * omega_k * beta_inverse(phys, current_time)

    qplus = torch.zeros_like(energy)
    if phys.heating_viscous:
        qplus = qplus + viscous_heating(phys, g, sigma, nu, tau_rr, tau_pp,
                                        tau_rp, div_v)

    gam = phys.adiabatic_index
    inv_pow4 = (phys.mu * (gam - 1.0) / (constants.R * sigma)) ** 4
    alpha = 1.0 + 2.0 * scale_height * 4.0 * constants.sigma_sb \
        / constants.c * inv_pow4 * energy ** 3
    qplus = qplus / alpha
    qminus = qminus / alpha

    e_new = energy + dt * (qplus - qminus)

    # near-floor cells go to the heating/cooling equilibrium, which with
    # tau_eff = 0 is zero energy (reference :1030-1044)
    near_floor = sigma < 10.0 * phys.sigma0 * phys.sigma_floor
    e_new = torch.where(near_floor, torch.zeros_like(e_new), e_new)
    qminus = torch.where(near_floor, qplus, qminus)

    energy = set_rows(energy, e_new, 1, nr - 1)
    energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)
    zero_row = torch.zeros_like(qplus[:1])
    qplus = torch.cat([zero_row, qplus[1:nr - 1], zero_row], dim=0)
    qminus = torch.cat([zero_row, qminus[1:nr - 1], zero_row], dim=0)
    return energy, qplus, qminus


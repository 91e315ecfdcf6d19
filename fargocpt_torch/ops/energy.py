"""Energy source substep (SubStep3), the subset the flagship, the PDS70
setups and the planet setups reach: viscous heating, stellar irradiation,
local beta cooling (towards the initial profile with
CoolingBetaReference), thermal surface cooling, the radiative correction
factor and the near-floor equilibrium (reference
src/SourceEuler.cpp:496-536, :538-611, :632-654, :790-820, :1018-1051).
S-curve cooling and the Ziampras beta variants are not ported yet and
raise."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..params import Physics
from .common import Geom, azim_next, set_rows
from . import eos, opacity as opacity_mod


def check_supported(phys: Physics) -> None:
    """Raise for every SubStep3 branch outside the ported subset."""
    unsupported = {
        "S-curve cooling": phys.cooling_scurve_enabled,
        "CoolingBetaMethod": phys.cooling_beta_method != "no",
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
    """1/beta with the optional ramp-up (reference src/SourceEuler.cpp:641-650).
    ``current_time`` is a float or a 0-d tensor; the result is a tensor
    only where the ramp is on and the time is one."""
    beta_inv = 1.0 / phys.cooling_beta
    if phys.cooling_beta_ramp_up > 0.0:
        arg = -(2.0 * current_time / phys.cooling_beta_ramp_up) ** 2
        ramp = 1.0 - (torch.exp(arg) if torch.is_tensor(arg)
                      else math.exp(arg))
        return beta_inv * ramp
    return beta_inv


def kappa_tau_eff(phys: Physics, constants, units, sigma, temperature,
                  scale_height):
    """Opacity, vertical optical depth and effective optical depth
    (reference src/compute.cpp:41-87 ``kappa_eff``)."""
    rho = sigma / (phys.density_factor * scale_height)
    kappa = opacity_mod.opacity(phys, units, rho, temperature)
    tau = phys.tau_factor / phys.density_factor * kappa * sigma
    if phys.opacity_mode == "simple":
        tau_eff = 3.0 / 8.0 * tau          # D'Angelo et al. 2003 eq. 28
    elif phys.heating_star:
        tau_eff = 3.0 / 8.0 * tau + 0.5 + 1.0 / (4.0 * tau + phys.tau_min)
    else:
        tau_eff = 3.0 / 8.0 * tau + math.sqrt(3.0) / 4.0 \
            + 1.0 / (4.0 * tau + phys.tau_min)
    return kappa, tau, tau_eff


@dataclass(frozen=True)
class IrradiationCtx:
    """What the stellar irradiation reads: the bodies on the grid (float64
    tensors), per body its radius, temperature and irradiation ramp-up
    time (tensors of the field type) and whether it irradiates, and the
    cells' Cartesian centres."""
    bodies: object                        # gravity.BodiesOnGrid
    radius: torch.Tensor
    temperature: torch.Tensor
    irradiates: list
    rampup: torch.Tensor
    cell_x: torch.Tensor
    cell_y: torch.Tensor


def irradiation(phys: Physics, constants, ctx: IrradiationCtx,
                aspect_ratio, tau_eff, current_time):
    """Stellar irradiation heating Q+ (Menou & Goodman 2004 via D'Angelo &
    Marzari 2012; reference src/SourceEuler.cpp:538-611,
    fargocpt_tpu/ops/energy.py:190-224). ``current_time`` is a float or a
    0-d tensor; body positions are cast to the field type."""
    dt = tau_eff.dtype
    qplus = torch.zeros_like(tau_eff)
    sig_sb = constants.sigma_sb
    dlogh_dlogr = 9.0 / 7.0   # Chiang & Goldreich 1997
    eps = 0.5
    t = torch.as_tensor(current_time, dtype=dt, device=tau_eff.device)
    for k, on in enumerate(ctx.irradiates):
        if not on:
            continue
        t_ramp = ctx.rampup[k]
        ramping = torch.where(
            (t_ramp > 0.0) & (t < t_ramp),
            1.0 - torch.cos(t * (math.pi / 2.0)
                            / torch.where(t_ramp > 0.0, t_ramp,
                                          torch.ones_like(t_ramp))) ** 2,
            torch.ones_like(t))
        x, y = ctx.bodies.x[k].to(dt), ctx.bodies.y[k].to(dt)
        r_star = ctx.radius[k]
        t_star = ctx.temperature[k]
        l1 = ctx.bodies.cubic_smoothing_radius[k].to(dt)
        off_center = x * x + y * y > 1e-10
        min_dist = torch.where(off_center, torch.maximum(r_star, l1), r_star)
        dist = torch.maximum(torch.sqrt((ctx.cell_x - x) ** 2
                                        + (ctx.cell_y - y) ** 2), min_dist)
        roverd = torch.where(dist < r_star, torch.ones_like(dist),
                             r_star / dist)
        w_g = 0.4 * roverd + aspect_ratio * (dlogh_dlogr - 1.0)
        t_irr4 = (1.0 - eps) * t_star ** 4 * roverd ** 2 * w_g
        qplus = qplus + ramping * 2.0 * sig_sb * t_irr4 / tau_eff
    return qplus


def thermal_cooling(phys: Physics, constants, temperature, tau_eff):
    """Surface cooling Q- = f 2 sigma_SB (T^4 - Tmin^4) / tau_eff
    (reference src/SourceEuler.cpp:790-820)."""
    return phys.surface_cooling_factor * 2.0 * constants.sigma_sb \
        * (temperature ** 4 - phys.minimum_temperature ** 4) / tau_eff


def substep3(phys: Physics, constants, g: Geom, sigma, energy, nu,
             tau_rr, tau_pp, tau_rp, div_v, scale_height, current_time, dt,
             units=None, pvte_vals=None, ref=None,
             irradiation_ctx: IrradiationCtx | None = None,
             aspect_grid=None):
    """Energy update with Q+ / Q- (reference src/SourceEuler.cpp:956-1051).
    Returns (energy_new, qplus, qminus); the Q grids are divided by the
    radiative correction factor and zero on the ghost rings.

    ``pvte_vals`` set gamma and mu of the correction factor, the
    equilibrium and the floor; the temperature of the surface cooling is
    the constant-gamma one, as in ``fargocpt_tpu.ops.energy``. Surface
    cooling and the irradiation (``irradiation_ctx``, with HeatingStar) need
    ``units`` (the opacity is fitted in cgs). ``aspect_grid`` is the
    ASPECTRATIO grid of the irradiation's H/R factor (``HydroStep.
    aspect_grid``); without it H / r, that of AspectRatioMode 0."""
    check_supported(phys)
    nr = g.nrad
    tau_eff = torch.zeros_like(sigma)
    temperature = None
    if (phys.cooling_surface_enabled or phys.heating_star) \
            and units is not None:
        temperature = eos.temperature(phys, constants, sigma, energy, None)
        _, _, tau_eff = kappa_tau_eff(phys, constants, units, sigma,
                                      temperature, scale_height)

    qminus = torch.zeros_like(energy)
    if phys.cooling_beta_enabled:
        omega_k = torch.sqrt(constants.G * phys.hydro_center_mass
                             / g.rb ** 3)
        delta_e = energy
        if phys.cooling_beta_reference:
            delta_e = delta_e - ref[1] / ref[0] * sigma
        qminus = qminus + delta_e * omega_k * beta_inverse(phys,
                                                           current_time)
    if phys.cooling_surface_enabled and temperature is not None:
        qminus = qminus + thermal_cooling(phys, constants, temperature,
                                          tau_eff)

    qplus = torch.zeros_like(energy)
    if phys.heating_viscous:
        qplus = qplus + viscous_heating(phys, g, sigma, nu, tau_rr, tau_pp,
                                        tau_rp, div_v)
    if phys.heating_star and irradiation_ctx is not None:
        aspect = aspect_grid if aspect_grid is not None \
            else scale_height * g.inv_rb
        qplus = qplus + irradiation(phys, constants, irradiation_ctx,
                                    aspect, tau_eff, current_time)

    if pvte_vals is not None:
        gam, mu, _ = pvte_vals
    else:
        gam, mu = eos.gamma_eff(phys), eos.mu_eff(phys)
    inv_pow4 = (mu * (gam - 1.0) / (constants.R * sigma)) ** 4
    alpha = 1.0 + 2.0 * scale_height * 4.0 * constants.sigma_sb \
        / constants.c * inv_pow4 * energy ** 3
    qplus = qplus / alpha
    qminus = qminus / alpha

    e_new = energy + dt * (qplus - qminus)

    # near-floor cells go to the instantaneous heating/cooling equilibrium
    # (reference :1030-1044); with tau_eff = 0 that is zero energy
    e4 = qplus * tau_eff / (2.0 * constants.sigma_sb)
    eq_energy = e4 ** 0.25 * (constants.R / mu * sigma / (gam - 1.0))
    near_floor = sigma < 10.0 * phys.sigma0 * phys.sigma_floor
    e_new = torch.where(near_floor, eq_energy, e_new)
    qminus = torch.where(near_floor, qplus, qminus)

    energy = set_rows(energy, e_new, 1, nr - 1)
    energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                      pvte_vals)
    zero_row = torch.zeros_like(qplus[:1])
    qplus = torch.cat([zero_row, qplus[1:nr - 1], zero_row], dim=0)
    qminus = torch.cat([zero_row, qminus[1:nr - 1], zero_row], dim=0)
    return energy, qplus, qminus


"""Energy source substep (SubStep3): viscous heating, stellar irradiation,
local beta cooling (towards the initial profile with
CoolingBetaReference, the model profile with CoolingBetaModel, the
temperature floor with CoolingBetaFloor; the Ziampras et al. 2023 local
beta of CoolingBetaMethod surf / mid / tot), thermal surface cooling, the
dwarf-nova S-curve cooling, the radiative correction factor and the
near-floor equilibrium (reference src/SourceEuler.cpp:496-1051;
fargocpt_tpu/ops/energy.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import telemetry
from ..params import Physics
from .common import Geom, azim_next, set_rows
from . import eos, opacity as opacity_mod


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


def beta_or_scurve_cooling(phys: Physics) -> bool:
    """S-curve cooling, or a beta cooling other than the constant one
    (CoolingBetaMethod, CoolingBetaModel, CoolingBetaFloor): none of them
    runs in the viscous_kick kernel, which ``step.gates`` keeps off under
    them."""
    return (phys.cooling_scurve_enabled or phys.cooling_beta_method != "no"
            or phys.cooling_beta_model or phys.cooling_beta_floor)


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


def _ziampras_beta_inv(phys: Physics, constants, sigma, energy,
                       temperature, kappa, scale_height, omega_k, pvte_vals):
    """The local beta of Ziampras et al. (2023) (reference
    src/SourceEuler.cpp:655-760; fargocpt_tpu/ops/energy.py:32-71):
    surf: 1/beta = |Q_surf| / (E Omega_K) with the surface-cooling rate;
    mid: 1/beta = eta / (Omega_K (H^2 + l_rad^2 / 3)), eta = 16 sigma_SB
    T^3 / (3 c_v kappa rho^2); tot: the sum of both. The reference's
    tau_eff here is 3 tau / 8 + pow(3, 1/2) / 4 + 1 / (4 tau), where the
    integer division makes pow(3, 1/2) = 1: a constant 0.25, kept as the
    JAX package keeps it."""
    rho = sigma / (phys.density_factor * scale_height)
    if pvte_vals is not None:
        gam, mu, _ = pvte_vals
    else:
        gam, mu = eos.gamma_eff(phys), eos.mu_eff(phys)
    method = phys.cooling_beta_method
    beta_inv = 0.0
    if method in ("surf", "tot"):
        tau = 0.5 * kappa * sigma
        tau_eff = 3.0 * tau / 8.0 + 0.25 + 1.0 / (4.0 * tau)
        q_surf = phys.surface_cooling_factor * 2.0 * constants.sigma_sb \
            * temperature ** 4 / tau_eff
        beta_inv = torch.abs(q_surf) / (energy * omega_k)
    if method in ("mid", "tot"):
        c_v = constants.R / (mu * (gam - 1.0))
        eta = 16.0 * constants.sigma_sb * temperature ** 3 \
            / (3.0 * c_v * kappa * rho ** 2)
        lrad = 1.0 / (rho * kappa)
        beta_inv_mid = eta / (omega_k * (scale_height ** 2
                                         + lrad ** 2 / 3.0))
        beta_inv = beta_inv_mid if method == "mid" \
            else beta_inv + beta_inv_mid
    return beta_inv


def beta_cooling(phys: Physics, constants, g: Geom, sigma, energy, ref,
                 current_time, temperature=None, kappa=None,
                 scale_height=None, pvte_vals=None):
    """Thermal relaxation Q- = dE Omega_K / beta (reference
    src/SourceEuler.cpp:632-786; fargocpt_tpu/ops/energy.py:74-103): dE
    the energy, less the initial profile's (``ref`` = (sigma0, energy0),
    CoolingBetaReference), the model profile's (CoolingBetaModel) or the
    temperature floor's (CoolingBetaFloor); beta the configured one with
    its ramp-up, or Ziampras's local beta under CoolingBetaMethod (given
    the temperature)."""
    omega_k = torch.sqrt(constants.G * phys.hydro_center_mass / g.rb ** 3)
    beta_inv = beta_inverse(phys, current_time)
    if phys.cooling_beta_method != "no" and temperature is not None:
        beta_inv = _ziampras_beta_inv(phys, constants, sigma, energy,
                                      temperature, kappa, scale_height,
                                      omega_k, pvte_vals)
    delta_e = energy
    if phys.cooling_beta_reference:
        delta_e = delta_e - ref[1] / ref[0] * sigma
    if phys.cooling_beta_model:
        e0 = 1.0 / (phys.adiabatic_index - 1.0) * phys.aspectratio_ref ** 2 \
            * g.rb ** (2.0 * phys.flaring_index - 1.0) \
            * constants.G * phys.hydro_center_mass * sigma
        delta_e = delta_e - e0
    if phys.cooling_beta_floor:
        e_min = phys.minimum_temperature * sigma / phys.mu * constants.R \
            / (eos.gamma_eff(phys) - 1.0)
        delta_e = delta_e - e_min
    return delta_e * omega_k * beta_inv


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


@telemetry.spanned("energy.irradiation")
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


@telemetry.spanned("energy.scurve_cooling")
def scurve_cooling(phys: Physics, constants, units, g: Geom, sigma,
                   temperature, mu_grid):
    """Dwarf-nova S-curve surface cooling (reference
    src/SourceEuler.cpp:823-928 ``scurve_cooling``;
    fargocpt_tpu/ops/energy.py:131-187): the cold, hot and intermediate
    branch fluxes of Ichikawa & Osaki 1992, or of the Kimura et al. 2020
    calibration (``ScurveType: kimura``, the default), scaled as power laws
    below the validity thresholds (2 g/cm^2, 1200 K) and limited to the
    blackbody flux. ``mu_grid`` is the mean molecular weight of each cell.
    Returns (qminus, tau_eff)."""
    sigma_cgs_thresh = 2.0
    temp_cgs_thresh = 1200.0
    if phys.scurve_kimura:
        f_hot_const, mu_exp = 23.405, 0.31
    else:
        f_hot_const, mu_exp = 25.49, -0.31

    sigma_cgs = sigma * units.surface_density
    sigma_t = torch.clamp(sigma_cgs, min=sigma_cgs_thresh)
    temp_cgs = temperature * units.temperature
    temp_t = torch.clamp(temp_cgs, min=temp_cgs_thresh)
    r_cgs = g.rb * units.length
    m_cgs = phys.hydro_center_mass * units.mass
    omega_cgs = torch.sqrt(constants.cgs_G * m_cgs / r_cgs ** 3)
    log_sb = math.log10(constants.cgs_sigma_sb)

    log10 = torch.log10
    log_ta = -1.0 / 5.49 * (0.62 * log10(omega_cgs) + 1.62 * log10(sigma_t)
                            + mu_exp * log10(mu_grid) - 25.48 - log_sb)
    ta = 10.0 ** log_ta
    log_fa = log_sb + 4.0 * log_ta
    k_cgs = 11.0 + 0.4 * log10(2.0e10 / r_cgs)
    log_fb = torch.maximum(k_cgs, log_fa)
    log_tb = (log_fb + log10(omega_cgs) + 2.0 * log10(sigma_t)
              + 0.5 * log10(mu_grid) + f_hot_const) / 8.0
    tb = 10.0 ** log_tb

    log_f_cold = 9.49 * log10(temp_t) + 0.62 * log10(omega_cgs) \
        + 1.62 * log10(sigma_t) + mu_exp * log10(mu_grid) - 25.48
    log_f_hot = 8.0 * log10(temp_t) - log10(omega_cgs) \
        - 2.0 * log10(sigma_t) - 0.5 * log10(mu_grid) - f_hot_const
    log_f_mid = (log_fa - log_fb) * log10(temp_t / tb) / log10(ta / tb) \
        + log_fb
    log_ftot = torch.where(temp_t < ta, log_f_cold,
                           torch.where(temp_t > tb, log_f_hot, log_f_mid))

    f_tot = 10.0 ** log_ftot / units.energy_flux
    # power-law scaling below the validity thresholds (reference :917-919)
    f_tot = f_tot * torch.sqrt(sigma_cgs / sigma_t) \
        * (temp_cgs / temp_t) ** 2
    t4 = temperature ** 4
    f_bb = constants.sigma_sb * t4
    factor = phys.surface_cooling_factor
    qminus = 2.0 * factor * torch.minimum(f_tot, f_bb)
    # max(qminus, 1e-300) is a clamp at 0 in float32, in both packages
    tau_eff = factor * 2.0 * constants.sigma_sb * t4 \
        / torch.clamp(qminus, min=1e-300)
    return qminus, tau_eff


@telemetry.spanned("energy.substep3")
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
    cooling, the S-curve, Ziampras's local beta and the irradiation
    (``irradiation_ctx``, with HeatingStar) need ``units`` (the opacity and
    the S-curve are fitted in cgs); the S-curve's mean molecular weight is
    the PVTE grid's where ``pvte_vals`` are given. ``ref`` = (sigma0,
    energy0), the initial profile of CoolingBetaReference. ``aspect_grid``
    is the ASPECTRATIO grid of the irradiation's H/R factor (``HydroStep.
    aspect_grid``); without it H / r, that of AspectRatioMode 0."""
    nr = g.nrad
    tau_eff = torch.zeros_like(sigma)
    temperature = kappa = None
    if (phys.cooling_surface_enabled or phys.heating_star
            or phys.cooling_scurve_enabled
            or phys.cooling_beta_method != "no") and units is not None:
        temperature = eos.temperature(phys, constants, sigma, energy, None)
        kappa, _, tau_eff = kappa_tau_eff(phys, constants, units, sigma,
                                          temperature, scale_height)

    qminus = torch.zeros_like(energy)
    if phys.cooling_beta_enabled:
        qminus = qminus + beta_cooling(
            phys, constants, g, sigma, energy, ref, current_time,
            temperature=temperature, kappa=kappa, scale_height=scale_height,
            pvte_vals=pvte_vals)
    if phys.cooling_surface_enabled and temperature is not None:
        qminus = qminus + thermal_cooling(phys, constants, temperature,
                                          tau_eff)
    if phys.cooling_scurve_enabled and temperature is not None:
        # the S-curve's tau_eff replaces the thermal one for the
        # irradiation and the near-floor equilibrium below
        mu_grid = pvte_vals[1] if pvte_vals is not None \
            else torch.full_like(sigma, phys.mu)
        q_sc, tau_eff = scurve_cooling(phys, constants, units, g, sigma,
                                       temperature, mu_grid)
        qminus = qminus + q_sc

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


"""Navier-Stokes viscosity: the kinematic viscosity (alpha, per cell under
AlphaMode 1-3, or a constant nu), the viscous stress tensor in 2-D
cylindrical coordinates, the velocity update from its divergence and the
correction factors of StabilizeViscosity (reference
src/viscosity/viscosity.cpp:31-137, :139-254, :256-354, :355-426)."""

from __future__ import annotations

import math

import torch

from .. import telemetry
from ..params import Physics
from .common import Geom, azim_next, azim_prev, set_rows
from .pvte import ionization_fraction
from .sources import divergence_v


@telemetry.spanned("viscosity.alpha_grid")
def alpha_grid(phys: Physics, g: Geom, units=None, temperature=None,
               sigma=None, scale_height=None, bodies=None,
               n_bodies: int = 0, cell_x=None, cell_y=None):
    """The alpha of each cell (reference src/viscosity/viscosity.cpp:31-93
    ``get_alpha``): mode 1 the temperature S-curve (a tanh blend in
    log T), mode 2 the ramp in the distance from the bodies, mode 3 the
    blend in the hydrogen ionisation fraction. Without what a mode reads
    (the temperature and units, or the bodies) it is the constant
    ViscousAlpha, as in the JAX package."""
    if phys.alpha_mode == 1 and temperature is not None and units is not None:
        t_cgs = temperature * units.temperature
        a_cold = phys.alpha_cold * (g.rb / 0.4) ** 0.3
        a_hot = phys.alpha_hot
        return 10.0 ** (
            0.5 * (math.log10(a_hot) - torch.log10(a_cold))
            * (1.0 - torch.tanh((4.0 - torch.log10(t_cgs)) / 0.4))
            + torch.log10(a_cold))
    if phys.alpha_mode == 2 and bodies is not None:
        alpha = torch.full_like(cell_x, phys.alpha_hot)
        dist_start, dist_end = 0.35, 0.55
        for k in range(n_bodies):
            d = torch.sqrt((cell_x - bodies.x[k]) ** 2
                           + (cell_y - bodies.y[k]) ** 2)
            scale = torch.clamp((d - dist_start) / (dist_end - dist_start),
                                0.0, 1.0)
            alpha = torch.minimum(
                alpha, phys.alpha_cold
                + (phys.alpha_hot - phys.alpha_cold) * scale)
        return alpha
    if phys.alpha_mode == 3 and temperature is not None \
            and units is not None:
        rho_cgs = sigma / (phys.density_factor * scale_height) \
            * units.density
        t_cgs = temperature * units.temperature
        x_ion = ionization_fraction(rho_cgs, t_cgs,
                                    phys.hydrogen_mass_fraction)
        return phys.alpha_cold + (phys.alpha_hot - phys.alpha_cold) \
            * torch.clamp(1000.0 * x_ion, max=1.0)
    return phys.viscous_alpha


def kinematic_viscosity(phys: Physics, g: Geom, cs, scale_height,
                        temperature=None, units=None, sigma=None,
                        bodies=None, n_bodies: int = 0, cell_x=None,
                        cell_y=None):
    """nu = alpha cs H, alpha per cell under AlphaMode != 0
    (``alpha_grid``), or the constant viscosity."""
    if phys.viscous_alpha > 0.0:
        alpha = phys.viscous_alpha
        if phys.alpha_mode != 0:
            alpha = alpha_grid(phys, g, units, temperature, sigma,
                               scale_height, bodies, n_bodies, cell_x,
                               cell_y)
        return alpha * cs * scale_height
    return torch.full_like(cs, phys.constant_viscosity)


@telemetry.spanned("viscosity.stress")
def viscous_stress_tensor(phys: Physics, g: Geom, sigma, vrad, vaz, nu):
    """tau_rr, tau_pp (cell centered), tau_rp (corner, rows 1..NR-1; row 0
    zero) and div_v."""
    nr = g.nrad
    div_v = divergence_v(g, vrad, vaz)

    drr = (vrad[1:] - vrad[:-1]) * g.inv_diff_rsup
    tau_rr = 2.0 * nu * sigma * (drr - div_v / 3.0)

    dpp = (azim_next(vaz) - vaz) * g.invdphi * g.inv_rb \
        + 0.5 * (vrad[1:] + vrad[:-1]) * g.inv_rb
    tau_pp = 2.0 * nu * sigma * (dpp - div_v / 3.0)

    inv_rb = g.inv_rb
    dvazirdr = (vaz[1:] * inv_rb[1:] - vaz[:-1] * inv_rb[:-1]) \
        * g.inv_diff_rmed[1:nr]
    dvrdphi = (vrad[1:nr] - azim_prev(vrad[1:nr])) * g.invdphi
    drp = g.ra[1:nr] * dvazirdr + dvrdphi * g.inv_ra[1:nr]
    nu4 = 0.25 * (nu[1:] + nu[:-1] + azim_prev(nu[1:]) + azim_prev(nu[:-1]))
    sig4 = 0.25 * (sigma[1:] + sigma[:-1]
                   + azim_prev(sigma[1:]) + azim_prev(sigma[:-1]))
    tau_rp = torch.cat([torch.zeros_like(drp[:1]), nu4 * sig4 * drp], dim=0)
    return tau_rr, tau_pp, tau_rp, div_v


@telemetry.spanned("viscosity.correction_factors")
def viscosity_correction_factors(phys: Physics, g: Geom, sigma, nu):
    """The StabilizeViscosity correction factors c_phi, c_r of each cell,
    rows 1..NR-1 (reference src/viscosity/viscosity.cpp:256-354): the
    implicit damping coefficients of the viscous velocity update, both
    negative. Returns (c_phi, c_r), (NR, NAZ) each, row 0 zero."""
    nr = g.nrad
    nu_sig = nu * sigma
    # the corner (vector grid) rows 1..NR-1: the 4-cell mean
    ns4 = 0.25 * (nu_sig[1:] + nu_sig[:-1]
                  + azim_prev(nu_sig[1:]) + azim_prev(nu_sig[:-1]))
    z = torch.zeros_like(nu_sig[:1])
    ns_rp = torch.cat([z, ns4, z], dim=0)                # (NR+1, NAZ)

    # the v_phi factor (reference :283-307)
    a = ns_rp * (g.ra ** 3 * g.inv_diff_rmed)            # rows 0..NR
    mid = slice(1, nr)
    cphi_rp = -g.inv_rb[mid] * g.two_diff_ra_sq[mid] * (a[2:nr + 1] + a[mid])
    cphi_pp = -g.four_third_inv_rb_invdphi_sq[mid] \
        * (nu_sig[mid] + azim_prev(nu_sig[mid]))
    sig_avg_phi = 0.5 * (sigma[mid] + azim_prev(sigma[mid]))
    c_phi_mid = (cphi_rp + cphi_pp) / (sig_avg_phi * g.rb[mid])

    # the v_r factor (reference :311-345)
    sig_avg_r = 0.5 * (sigma[1:] + sigma[:-1])           # faces 1..NR-1
    cr_rp = -(azim_next(ns_rp[mid]) + ns_rp[mid]) \
        / (g.dphi * g.dphi * g.ra[mid])
    cr_pp_1 = 2.0 * nu_sig[1:] * (0.5 * g.inv_rb[1:]
                                  + (1.0 / 3.0) * g.ra[mid]
                                  * g.inv_diff_rsup_rb[1:])
    cr_pp_2 = 2.0 * nu_sig[:-1] * (0.5 * g.inv_rb[:-1]
                                   - (1.0 / 3.0) * g.ra[mid]
                                   * g.inv_diff_rsup_rb[:-1])
    cr_rr_1 = g.rb[1:] * 2.0 * nu_sig[1:] * (
        -g.inv_diff_rsup[1:] + (1.0 / 3.0) * g.ra[mid]
        * g.inv_diff_rsup_rb[1:])
    cr_rr_2 = -g.rb[:-1] * 2.0 * nu_sig[:-1] * (
        g.inv_diff_rsup[:-1] - (1.0 / 3.0) * g.ra[mid]
        * g.inv_diff_rsup_rb[:-1])
    cr_pp = -0.5 * (cr_pp_1 + cr_pp_2)
    cr_rr = g.inv_diff_rmed[mid] * (cr_rr_1 + cr_rr_2)
    rmed_mid = 0.5 * (g.rb[1:] + g.rb[:-1])
    c_r_mid = phys.radial_viscosity_factor * (cr_rr + cr_rp + cr_pp) \
        / (sig_avg_r * rmed_mid)
    return torch.cat([z, c_phi_mid], dim=0), torch.cat([z, c_r_mid], dim=0)


def _stabilize_corr(c, dt):
    """1 / (max(1 + dt c, 0) - dt c) (reference :386-391, :413-417)."""
    return 1.0 / (torch.clamp(1.0 + dt * c, min=0.0) - dt * c)


@telemetry.spanned("viscosity.update")
def update_velocities_with_viscosity(phys: Physics, g: Geom, sigma,
                                     vrad, vaz, tau_rr, tau_pp, tau_rp, dt,
                                     nu=None):
    """Conservative-form velocity update: v_az rows 1..NR-2, v_rad faces
    2..NR-2. Under StabilizeViscosity 1, given the viscosity grid ``nu``,
    each update is scaled by its implicit correction factor (reference
    :386-391, :413-417)."""
    nr = g.nrad
    c_phi = c_r = None
    if phys.stabilize_viscosity == 1 and nu is not None:
        c_phi, c_r = viscosity_correction_factors(phys, g, sigma, nu)
    ra_sq = g.ra ** 2
    sig_avg_phi = 0.5 * (sigma + azim_prev(sigma))
    trp_rsq = ra_sq[:nr] * tau_rp
    trp_rsq_up = torch.cat([trp_rsq[1:], torch.zeros_like(trp_rsq[:1])],
                           dim=0)
    dvp = dt * g.inv_rb / sig_avg_phi * (
        g.two_diff_ra_sq * (trp_rsq_up - trp_rsq)
        + (tau_pp - azim_prev(tau_pp)) * g.invdphi)
    if c_phi is not None:
        dvp = dvp * _stabilize_corr(c_phi, dt)
    vaz = set_rows(vaz, vaz + dvp, 1, nr - 1)

    rb = g.rb
    sig_avg_r = 0.5 * (sigma[1:] + sigma[:-1])        # faces 1..NR-1
    dvr = dt / sig_avg_r * phys.radial_viscosity_factor \
        * 2.0 / (rb[1:] + rb[:-1]) * (
            (rb[1:] * tau_rr[1:] - rb[:-1] * tau_rr[:-1])
            * g.inv_diff_rmed[1:nr]
            + (azim_next(tau_rp[1:]) - tau_rp[1:]) * g.invdphi
            - 0.5 * (tau_pp[1:] + tau_pp[:-1]))
    if c_r is not None:
        dvr = dvr * _stabilize_corr(c_r[1:], dt)
    vrad = torch.cat([vrad[:2], vrad[2:nr - 1] + dvr[1:nr - 2],
                      vrad[nr - 1:]], dim=0)
    return vrad, vaz

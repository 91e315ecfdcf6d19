"""Navier-Stokes viscosity: the kinematic viscosity (a constant alpha or
nu), the viscous stress tensor in 2-D cylindrical coordinates and the
velocity update from its divergence (reference
src/viscosity/viscosity.cpp:31-137, :139-254, :256-354). AlphaMode and
StabilizeViscosity are not in this copy (``scope.py``)."""

from __future__ import annotations

import torch

from ..params import Physics
from .common import Geom, azim_next, azim_prev, set_rows
from .sources import divergence_v


def kinematic_viscosity(phys: Physics, g: Geom, cs, scale_height):
    """nu = alpha cs H, or the constant viscosity."""
    if phys.viscous_alpha > 0.0:
        return phys.viscous_alpha * cs * scale_height
    return torch.full_like(cs, phys.constant_viscosity)


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


def update_velocities_with_viscosity(phys: Physics, g: Geom, sigma,
                                     vrad, vaz, tau_rr, tau_pp, tau_rp, dt,
                                     nu=None):
    """Conservative-form velocity update: v_az rows 1..NR-2, v_rad faces
    2..NR-2."""
    nr = g.nrad
    ra_sq = g.ra ** 2
    sig_avg_phi = 0.5 * (sigma + azim_prev(sigma))
    trp_rsq = ra_sq[:nr] * tau_rp
    trp_rsq_up = torch.cat([trp_rsq[1:], torch.zeros_like(trp_rsq[:1])],
                           dim=0)
    dvp = dt * g.inv_rb / sig_avg_phi * (
        g.two_diff_ra_sq * (trp_rsq_up - trp_rsq)
        + (tau_pp - azim_prev(tau_pp)) * g.invdphi)
    vaz = set_rows(vaz, vaz + dvp, 1, nr - 1)

    rb = g.rb
    sig_avg_r = 0.5 * (sigma[1:] + sigma[:-1])        # faces 1..NR-1
    dvr = dt / sig_avg_r * phys.radial_viscosity_factor \
        * 2.0 / (rb[1:] + rb[:-1]) * (
            (rb[1:] * tau_rr[1:] - rb[:-1] * tau_rr[:-1])
            * g.inv_diff_rmed[1:nr]
            + (azim_next(tau_rp[1:]) - tau_rp[1:]) * g.invdphi
            - 0.5 * (tau_pp[1:] + tau_pp[:-1]))
    vrad = torch.cat([vrad[:2], vrad[2:nr - 1] + dvr[1:nr - 2],
                      vrad[nr - 1:]], dim=0)
    return vrad, vaz

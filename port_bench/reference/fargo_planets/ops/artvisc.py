"""Artificial viscosity: Stone-Norman (von Neumann-Richtmyer) and
Tscharnuter-Winkler variants (reference
src/viscosity/artificial_viscosity.cpp)."""

from __future__ import annotations

import torch

from ..params import Physics, ARTVISC_SN, ARTVISC_TW
from .common import Geom, azim_next, azim_prev, set_rows


def _add_faces(vrad, dvr, nr: int):
    """vrad with faces 2..NR-2 incremented by dvr (indexed from face 1)."""
    return torch.cat([vrad[:2], vrad[2:nr - 1] + dvr[1:nr - 2],
                      vrad[nr - 1:]], dim=0)


def update_sn(phys: Physics, g: Geom, sigma, vrad, vaz, energy, dt):
    """Stone & Norman 1992 artificial viscous pressure
    (reference src/viscosity/artificial_viscosity.cpp:148-250)."""
    nr = g.nrad
    c2 = phys.artificial_viscosity_factor ** 2
    zero = torch.zeros_like(sigma)

    dv_r = vrad[1:] - vrad[:-1]                    # (NR, NAZ), cell centered
    dv_phi = azim_next(vaz) - vaz

    q_r = torch.where(dv_r < 0.0, c2 * sigma * dv_r ** 2, zero)
    q_phi = torch.where(dv_phi < 0.0, c2 * sigma * dv_phi ** 2, zero)

    if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
        invdxtheta = g.inv_rb * g.invdphi
        e_new = energy - dt * q_r * dv_r * g.inv_diff_rsup \
            - dt * q_phi * dv_phi * invdxtheta
        energy = set_rows(energy, e_new, 1, nr - 1)

    dvr = -dt * 2.0 / (sigma[1:] + sigma[:-1]) * (q_r[1:] - q_r[:-1]) \
        * g.inv_diff_rmed[1:nr]                    # faces 1..NR-1
    vrad = _add_faces(vrad, dvr, nr)

    invdxtheta = g.inv_rb * g.invdphi
    dvaz = -dt * 2.0 / (sigma + azim_prev(sigma)) \
        * (q_phi - azim_prev(q_phi)) * invdxtheta
    vaz = set_rows(vaz, vaz + dvaz, 1, nr - 1)
    return vrad, vaz, energy


def tw_length_sq(phys: Physics, g: Geom):
    """(C l)^2 of the tensor artificial viscosity
    (reference artificial_viscosity.cpp:58-67)."""
    dr = g.ra[1:] - g.ra[:-1]
    rdphi = g.rb * g.dphi
    if g.naz <= 16:
        dx = torch.minimum(dr, rdphi)              # pseudo-1D fix
    else:
        dx = torch.maximum(dr, rdphi)
    return phys.artificial_viscosity_factor ** 2 * dx ** 2


def update_tw(phys: Physics, g: Geom, sigma, vrad, vaz, energy, dt):
    """Tscharnuter & Winkler 1979 tensor artificial viscosity with the
    off-diagonal terms zeroed (reference
    src/viscosity/artificial_viscosity.cpp:35-140)."""
    nr = g.nrad
    eps_rr = (vrad[1:] - vrad[:-1]) * g.inv_diff_rsup
    eps_pp = g.inv_rb * ((azim_next(vaz) - vaz) * g.invdphi
                         + 0.5 * (vrad[1:] + vrad[:-1]))
    div_v = torch.clamp(eps_rr + eps_pp, max=0.0)
    l_sq = tw_length_sq(phys, g)

    q_rr = l_sq * sigma * (-div_v) * (eps_rr - div_v / 3.0)
    q_pp = l_sq * sigma * (-div_v) * (eps_pp - div_v / 3.0)

    if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
        qplus = -l_sq * div_v * sigma / 3.0 * \
            (eps_rr ** 2 + eps_pp ** 2 + (eps_rr - eps_pp) ** 2)
        energy = set_rows(energy, energy + qplus * dt, 2, nr - 1)

    sig_phi = 0.5 * (sigma + azim_prev(sigma))
    dvaz = 2.0 * dt / ((g.rsup + g.rinf) * sig_phi) \
        * (q_pp - azim_prev(q_pp)) * g.invdphi
    vaz = set_rows(vaz, vaz + dvaz, 1, nr - 1)

    sig_r = 0.5 * (sigma[1:] + sigma[:-1])         # faces 1..NR-1
    rb = g.rb
    dvr = phys.radial_viscosity_factor * dt / sig_r * \
        2.0 / (rb[1:] ** 2 - rb[:-1] ** 2) * \
        ((q_rr[1:] * rb[1:] - q_rr[:-1] * rb[:-1])
         - 0.5 * (q_pp[1:] + q_pp[:-1]) * (rb[1:] - rb[:-1]))
    vrad = _add_faces(vrad, dvr, nr)
    return vrad, vaz, energy


def update_with_artificial_viscosity(phys: Physics, g: Geom, sigma, vrad,
                                     vaz, energy, dt):
    """Dispatch (reference src/viscosity/artificial_viscosity.cpp:11-26);
    the temperature clamp after dissipation is the caller's."""
    if phys.artificial_viscosity == ARTVISC_TW:
        return update_tw(phys, g, sigma, vrad, vaz, energy, dt)
    if phys.artificial_viscosity == ARTVISC_SN:
        return update_sn(phys, g, sigma, vrad, vaz, energy, dt)
    return vrad, vaz, energy

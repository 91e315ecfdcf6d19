"""Artificial viscosity: Stone-Norman (von Neumann-Richtmyer) and
Tscharnuter-Winkler variants (reference
src/viscosity/artificial_viscosity.cpp)."""

from __future__ import annotations

import torch

from ..params import Physics, ARTVISC_SN
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


def update_with_artificial_viscosity(phys: Physics, g: Geom, sigma, vrad,
                                     vaz, energy, dt):
    """Dispatch (reference src/viscosity/artificial_viscosity.cpp:11-26);
    the temperature clamp after dissipation is the caller's."""
    if phys.artificial_viscosity == ARTVISC_SN:
        return update_sn(phys, g, sigma, vrad, vaz, energy, dt)
    return vrad, vaz, energy

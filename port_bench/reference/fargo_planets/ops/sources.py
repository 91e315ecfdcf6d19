"""Euler-equation source terms (pressure, gravity, centrifugal) and the
adiabatic compression heating (reference src/SourceEuler.cpp:325-493).

Interior v_rad faces are rows 2..NR-2, interior cell rings 1..NR-2
(reference src/split.cpp:66-70).
"""

from __future__ import annotations

import torch

from ..params import Physics
from .common import Geom, azim_next, azim_prev, set_rows


def divergence_v(g: Geom, vrad, vaz):
    """div(v) on cell centers (reference src/viscosity/viscosity.cpp:148-160)."""
    radial = (vrad[1:] * g.ra[1:] - vrad[:-1] * g.ra[:-1]) * g.inv_diff_rsup_rb
    azim = (azim_next(vaz) - vaz) * g.invdphi * g.inv_rb
    return radial + azim


def momentum_update_radial(phys: Physics, g: Geom, sigma, press, pot,
                           vrad, vaz, omega_frame, dt):
    """reference src/SourceEuler.cpp:325-372. Updates v_rad rows 2..NR-2."""
    nr = g.nrad
    sig_sum = sigma[1:] + sigma[:-1]                       # faces 1..NR-1
    gradp = 2.0 / sig_sum * (press[1:] - press[:-1]) * g.inv_diff_rmed[1:nr]
    gradphi = (pot[1:] - pot[:-1]) * g.inv_diff_rmed[1:nr]
    vsum = (vaz[1:] + azim_next(vaz[1:]) + vaz[:-1] + azim_next(vaz[:-1]))
    vt = 0.25 * vsum + g.ra[1:nr] * omega_frame
    centrifugal = vt * vt * g.inv_ra[1:nr]
    dv = dt * (-gradp - gradphi + centrifugal)             # index 0 <-> face 1
    return torch.cat([vrad[:2], vrad[2:nr - 1] + dv[1:nr - 2],
                      vrad[nr - 1:]], dim=0)


def momentum_update_azimuthal(phys: Physics, g: Geom, sigma, press, pot,
                              vaz, dt):
    """reference src/SourceEuler.cpp:375-428. Updates v_az rows 1..NR-2."""
    nr = g.nrad
    invdxtheta = 2.0 / (g.dphi * (g.rsup + g.rinf))
    gradp = 2.0 / (sigma + azim_prev(sigma)) * (press - azim_prev(press)) \
        * invdxtheta
    gradphi = (pot - azim_prev(pot)) * invdxtheta
    new = vaz + dt * (-gradp - gradphi)
    if phys.imposed_disk_drift != 0.0:
        supp = phys.imposed_disk_drift * 0.5 * \
            g.rb ** (-2.5 + phys.sigma_slope)
        new = new + dt * supp
    return set_rows(vaz, new, 1, nr - 1)


def compression_heating(phys: Physics, g: Geom, energy, vrad, vaz, dt,
                        pvte_vals=None):
    """E *= exp(-(gamma-1) dt div v), rows 0..NR-2, gamma = gamma_eff of
    ``pvte_vals`` when given (reference src/SourceEuler.cpp:459-493)."""
    if not phys.is_adiabatic:
        return energy
    div_v = divergence_v(g, vrad, vaz)
    gam = pvte_vals[0] if pvte_vals is not None else phys.adiabatic_index
    new = energy * torch.exp(-(gam - 1.0) * dt * div_v)
    return set_rows(energy, new, 0, g.nrad - 1)


def update_with_sourceterms(phys: Physics, g: Geom, sigma, press, pot,
                            vrad, vaz, energy, omega_frame, dt,
                            compress: bool = True, pvte_vals=None):
    """reference src/SourceEuler.cpp:435-452. ``compress=False`` leaves
    the compression heating to the viscous kick, which folds it into its
    first stage; ``pvte_vals`` give its gamma under PVTE."""
    vrad = momentum_update_radial(phys, g, sigma, press, pot, vrad, vaz,
                                  omega_frame, dt)
    vaz = momentum_update_azimuthal(phys, g, sigma, press, pot, vaz, dt)
    if compress:
        energy = compression_heating(phys, g, energy, vrad, vaz, dt,
                                     pvte_vals)
    return vrad, vaz, energy

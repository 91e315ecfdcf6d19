"""CFL time-step condition (reference src/cfl.cpp:185-382
``condition_cfl``): per-cell inverse-dt terms combined as
CFL / sqrt(sum invdt_i^2) over the active rings, plus the FARGO shear
limit (Masset 2000 Sect. 3.3)."""

from __future__ import annotations

import torch

from ..params import Physics, ARTVISC_SN, LEAPFROG
from .common import Geom, azim_next


def shear_limit(phys: Physics, g: Geom, vmean: torch.Tensor) -> torch.Tensor:
    """FARGO shear limit between rings i, i+1; the reference seeds with
    rings (0,1) and scans i in [1, NR-2)."""
    omega_row = vmean * g.inv_rb
    denom = torch.abs(omega_row[:-1] - omega_row[1:]) + 1e-100
    return torch.min((phys.cfl * g.dphi / denom)[:g.nrad - 2])


def inverse_dt_squared(phys: Physics, g: Geom, sigma, vrad, vaz, energy,
                       cs, nu, qplus, qminus, vmean) -> torch.Tensor:
    """The per-cell sum of the squared inverse-dt terms (NR, NAZ), with
    ``vmean`` (NR, 1) the rings' mean of ``vaz``. A cell reads its own ring
    and the face above it, nothing of another ring."""
    lf = 0.6 if phys.hydro_integrator == LEAPFROG else 1.0
    dxrad = g.dxrad
    dxaz = g.rb * g.dphi
    cell_size = torch.minimum(dxrad, dxaz)
    vres = vaz - vmean if phys.fast_transport else vaz

    invdt1 = cs / cell_size
    invdt2 = vrad[:-1] / dxrad
    invdt3 = vres / dxaz

    dv_r = vrad[1:] - vrad[:-1]
    dv_phi = azim_next(vaz) - vaz
    c2 = phys.artificial_viscosity_factor ** 2
    if phys.artificial_viscosity == ARTVISC_SN:
        invdt4 = 4.0 * c2 * torch.maximum(
            torch.clamp(-dv_r, min=0.0) / dxrad,
            torch.clamp(-dv_phi, min=0.0) / dxaz) * lf
    else:
        # TW, also used when artificial viscosity is off (src/cfl.cpp:292-301)
        eps_rr = dv_r * g.inv_diff_rsup
        eps_pp = g.inv_rb * (dv_phi * g.invdphi
                             + 0.5 * (vrad[1:] + vrad[:-1]))
        invdt4 = 4.0 * c2 * -torch.clamp(eps_rr + eps_pp, max=0.0) * lf

    invdt5 = 4.0 * nu / cell_size ** 2 * lf
    if phys.is_adiabatic:
        invdt6 = (1.0 / phys.heating_cooling_cfl_limit) \
            * torch.abs((qplus - qminus) / energy) * lf
    else:
        invdt6 = torch.zeros_like(invdt1)

    return invdt1 ** 2 + invdt2 ** 2 + invdt3 ** 2 + invdt4 ** 2 \
        + invdt5 ** 2 + invdt6 ** 2


def condition_cfl(phys: Physics, g: Geom, sigma, vrad, vaz, energy, cs, nu,
                  qplus, qminus) -> torch.Tensor:
    """Returns the CFL dt as a 0-d tensor. StabilizeViscosity 2 adds the
    viscosity's stability limit dt < -CFL / c (reference
    src/cfl.cpp:330-350)."""
    nr = g.nrad
    vmean = torch.mean(vaz, dim=-1, keepdim=True)
    dt_shear = shear_limit(phys, g, vmean)
    inv_sq = inverse_dt_squared(phys, g, sigma, vrad, vaz, energy, cs, nu,
                                qplus, qminus, vmean)
    dt_cell = phys.cfl / torch.sqrt(inv_sq)
    return torch.minimum(dt_shear, torch.min(dt_cell[1:nr - 1]))

"""The fused ops of the time step as plain PyTorch, on any device.

A frozen copy of the port's plain versions (the definitions its CUDA
kernels are held to): CFL, sources, viscous kick, the whole FARGO
transport and the Stone-Norman artificial viscosity. Every entry point below runs the plain version whatever the
tensors' device, so this package runs on the card without a kernel of the
port. ``KernelContext`` keeps the port's layout of what the ops read.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..grid import Geometry
from ..params import Physics
from . import artvisc, cfl as cfl_ops, energy as energy_ops, eos, gravity, \
    sources as src_ops, transport as tr_ops, viscosity as visc
from .common import Geom

ROUTES = ("whole",)


# ---------------------------------------------------------------------------
# geometry columns shared by the kernels (order = csrc/common.cuh enum Col)
# ---------------------------------------------------------------------------

KERNEL_COLUMNS = (
    "rb", "inv_rb", "ra", "inv_ra", "invdrm", "inv_diff_rsup",
    "inv_diff_rsup_rb", "two_diff_ra_sq", "inv_surf", "cm", "cp", "coef",
    "src_invdxtheta", "hfac", "cs_iso", "omega_k", "drift", "inv_cell",
    "inv_dxrad", "inv_dxaz", "sum_rs_ri", "l_sq")
N_COLS = 24


def make_columns(phys: Physics, constants, geometry: Geometry) -> np.ndarray:
    """(NR+1, N_COLS) float64 table of the per-ring geometry the kernels
    read; rows past a column's length are zero."""
    nr = geometry.nrad
    rb = geometry.rmed
    rinf, rsup = geometry.rinf, geometry.rsup
    rme = geometry.rmed_ext
    dphi = geometry.dphi
    gm = constants.G * phys.hydro_center_mass
    omega_k = np.sqrt(gm / rb ** 3)
    hfac = 1.0 / (math.sqrt(phys.adiabatic_index) * omega_k) \
        if phys.is_adiabatic else 1.0 / omega_k
    dxrad = rsup - rinf
    dxaz = rb * dphi
    dr = geometry.ra[1:] - geometry.ra[:-1]
    dx_tw = np.minimum(dr, dxaz) if geometry.naz <= 16 else np.maximum(dr, dxaz)
    drift = np.zeros(nr)
    if phys.imposed_disk_drift != 0.0:
        drift = phys.imposed_disk_drift * 0.5 * rb ** (-2.5 + phys.sigma_slope)
    named = {
        "rb": rb, "inv_rb": geometry.inv_rmed, "ra": geometry.ra,
        "inv_ra": geometry.inv_rinf, "invdrm": geometry.inv_diff_rmed,
        "inv_diff_rsup": geometry.inv_diff_rsup,
        "inv_diff_rsup_rb": geometry.inv_diff_rsup_rb,
        "two_diff_ra_sq": geometry.two_diff_ra_sq,
        "inv_surf": geometry.inv_surf,
        "cm": np.concatenate([[0.0], rme[1:] - rme[:-1]]),
        "cp": np.concatenate([rme[1:] - rme[:-1], [0.0]]),
        "coef": dxrad,
        "src_invdxtheta": 2.0 / (dphi * (rsup + rinf)),
        "hfac": hfac,
        "cs_iso": phys.aspectratio_ref * rb ** phys.flaring_index
        * np.sqrt(gm / rb),
        "omega_k": omega_k,
        "drift": drift,
        "inv_cell": 1.0 / np.minimum(dxrad, dxaz),
        "inv_dxrad": 1.0 / dxrad,
        "inv_dxaz": 1.0 / dxaz,
        "sum_rs_ri": rsup + rinf,
        "l_sq": phys.artificial_viscosity_factor ** 2 * dx_tw ** 2,
    }
    table = np.zeros((nr + 1, N_COLS))
    for k, name in enumerate(KERNEL_COLUMNS):
        a = np.asarray(named[name], np.float64)
        table[:a.shape[0], k] = a
    return table


class KernelContext(nn.Module):
    """Everything the ops read besides the fields: the physics and
    constants, the ``Geom`` columns, the kernels' column table, the
    azimuth rows, the isothermal sound-speed profile, and the transport
    route: the grid's (``transport.route``) unless ``transport_route``
    names one of ``ROUTES``. All tensors are buffers, so ``.to(device)``
    moves every one of them."""

    def __init__(self, phys: Physics, constants, geometry: Geometry,
                 dtype: torch.dtype, device: torch.device | str | None = None,
                 transport_route: str | None = None):
        super().__init__()
        if transport_route not in (None, *ROUTES):
            raise ValueError(f"transport_route must be one of {ROUTES} or "
                             f"None, got {transport_route!r}")
        self.phys = phys
        self.constants = constants
        self.route = transport_route or tr_ops.route(geometry.nrad)
        self.g = Geom(geometry, dtype, device)
        self.register_buffer("cols", torch.tensor(
            make_columns(phys, constants, geometry), dtype=dtype,
            device=device))
        self.register_buffer("cos_row", torch.tensor(
            geometry.cos_phi, dtype=dtype, device=device))
        self.register_buffer("sin_row", torch.tensor(
            geometry.sin_phi, dtype=dtype, device=device))
        self.register_buffer("cs_iso", eos.sound_speed_iso_profile(
            phys, constants, self.g.rb))
        self._scratch: dict[tuple, tuple[torch.Tensor, ...]] = {}


    def cell_xy(self):
        """Cartesian cell centers (NR, NAZ)."""
        return self.g.rb * self.cos_row[None, :], \
            self.g.rb * self.sin_row[None, :]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the definitions the kernels are held to)
# ---------------------------------------------------------------------------

def derived(ctx: KernelContext, sigma, energy, pvte_vals=None):
    """Sound speed, pressure and scale height (AspectRatioMode 0), with the
    PVTE grids ``pvte_vals`` when given."""
    phys, constants, g = ctx.phys, ctx.constants, ctx.g
    cs = eos.sound_speed(phys, constants, g, sigma, energy, ctx.cs_iso,
                         pvte_vals)
    press = eos.pressure(phys, constants, sigma, energy, cs, pvte_vals)
    h = eos.scale_height(phys, constants, g, cs, pvte_vals)
    return cs, press, h


def cfl_plain(ctx: KernelContext, sigma, vrad, vaz, energy, qplus, qminus):
    """CFL dt (0-d) from the ported condition_cfl."""
    cs, _, h = derived(ctx, sigma, energy)
    nu = visc.kinematic_viscosity(ctx.phys, ctx.g, cs, h)
    return cfl_ops.condition_cfl(ctx.phys, ctx.g, sigma, vrad, vaz, energy,
                                 cs, nu, qplus, qminus)


def sources_plain(ctx: KernelContext, sigma, vrad, vaz, energy,
                  bodies: gravity.BodiesOnGrid, indirect, omega_frame, dt,
                  h_smooth=None):
    """N-body potential + momentum source terms, without the compression
    heating. The potential's per-cell smoothing is eps times ``h_smooth``
    (NR, NAZ) where given, else eps times the scale height of the current
    fields. Returns (vrad, vaz)."""
    phys = ctx.phys
    _, press, h = derived(ctx, sigma, energy)
    cell_x, cell_y = ctx.cell_xy()
    pot = gravity.nbody_potential(phys, ctx.constants, ctx.g, bodies,
                                  bodies.x.shape[0], cell_x, cell_y,
                                  h if h_smooth is None else h_smooth,
                                  indirect[0], indirect[1])
    vrad, vaz, _ = src_ops.update_with_sourceterms(
        phys, ctx.g, sigma, press, pot, vrad, vaz, energy,
        omega_frame.to(sigma.dtype), dt, compress=False)
    return vrad, vaz


def viscous_kick_plain(ctx: KernelContext, sigma, vrad, vaz, energy, dt,
                       time, compress: bool = True, want_cs: bool = False):
    """Compression heating (optional), artificial viscosity, the clamp,
    viscosity and SubStep3. Returns (vrad, vaz, energy, qplus, qminus),
    with ``want_cs`` and the in-kick sound speed: the one the viscosity
    stage derives from the energy after the artificial viscosity and the
    clamp."""
    phys, constants, g = ctx.phys, ctx.constants, ctx.g
    if compress:
        energy = src_ops.compression_heating(phys, g, energy, vrad, vaz, dt)
    vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
        phys, g, sigma, vrad, vaz, energy, dt)
    if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
        energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)
    cs, _, h = derived(ctx, sigma, energy)
    nu = visc.kinematic_viscosity(phys, g, cs, h)
    trr, tpp, trp, divv = visc.viscous_stress_tensor(phys, g, sigma, vrad,
                                                     vaz, nu)
    vrad, vaz = visc.update_velocities_with_viscosity(
        phys, g, sigma, vrad, vaz, trr, tpp, trp, dt)
    if not phys.is_adiabatic:
        qplus = qminus = torch.zeros_like(sigma)
    else:
        energy, qplus, qminus = energy_ops.substep3(
            phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
            time, dt)
    if want_cs:
        return vrad, vaz, energy, qplus, qminus, cs
    return vrad, vaz, energy, qplus, qminus


def transport_plain(ctx: KernelContext, sigma, vrad, vaz, energy,
                    omega_frame, dt, shift, route=None):
    """The composed FARGO transport by ``route`` (the context's when
    None). Returns (sigma, vrad, vaz, energy, mass_flux)."""
    if (route or ctx.route) != "whole":
        raise ValueError("the benchmark's reference has the whole route only")
    return tr_ops.transport(ctx.phys, ctx.g, sigma, vrad, vaz, energy,
                            omega_frame.to(sigma.dtype), dt, shift=shift)


def artvisc_sn_plain(ctx: KernelContext, sigma, vrad, vaz, energy, dt):
    """The Stone-Norman artificial viscosity. Returns (vrad, vaz, energy)."""
    return artvisc.update_sn(ctx.phys, ctx.g, sigma, vrad, vaz, energy, dt)


# ---------------------------------------------------------------------------
# the ops: the plain version on every device
# ---------------------------------------------------------------------------

def cfl(ctx: KernelContext, sigma, vrad, vaz, energy, qplus, qminus):
    """CFL dt as a 0-d tensor of the field dtype."""
    return cfl_plain(ctx, sigma, vrad, vaz, energy, qplus, qminus)


def sources(ctx: KernelContext, sigma, vrad, vaz, energy,
            bodies: gravity.BodiesOnGrid, indirect, omega_frame, dt,
            h_smooth=None):
    """Potential + momentum source terms. Returns (vrad, vaz)."""
    return sources_plain(ctx, sigma, vrad, vaz, energy, bodies, indirect,
                         omega_frame, dt, h_smooth)


def viscous_kick(ctx: KernelContext, sigma, vrad, vaz, energy, dt, time,
                 compress: bool = True, want_cs: bool = False):
    """Returns (vrad, vaz, energy, qplus, qminus), with ``want_cs`` and the
    in-kick sound speed."""
    return viscous_kick_plain(ctx, sigma, vrad, vaz, energy, dt, time,
                              compress, want_cs)


def transport(ctx: KernelContext, sigma, vrad, vaz, energy, omega_frame, dt,
              shift=None, route=None):
    """FARGO transport by ``route`` (the context's when None). Returns
    (sigma, vrad, vaz, energy, mass_flux)."""
    if shift is None:
        shift = tr_ops.fargo_shift(ctx.g, vaz, dt)
    return transport_plain(ctx, sigma, vrad, vaz, energy, omega_frame, dt,
                           shift, route)


def artvisc_sn(ctx: KernelContext, sigma, vrad, vaz, energy, dt):
    """The Stone-Norman artificial viscosity. Returns (vrad, vaz,
    energy)."""
    return artvisc_sn_plain(ctx, sigma, vrad, vaz, energy, dt)



"""Lagrangian dust particles: drag and the exponential midpoint
integrator.

Re-derivation of reference src/particles/particles.cpp, the counterpart of
fargocpt_tpu/particles/dust.py: the swarm is a struct of (N,) tensors on
the run's device, integrated in lockstep with the gas step; the
per-particle loops are vectorised takes from the flattened gas grids
(``torch.take``, int64 indices).

Physics:
  * stopping time: Woitke & Helling 2002 / Picogna, Stoll & Kley 2018
    blended Epstein + Stokes drag law (reference :1130-1215 calc_tstop)
  * the integrator: the semi-implicit exponential midpoint in polar
    coordinates (Zhu et al. 2014 A4-A12 with the Mignone et al. 2019
    exponential propagator; reference :1579-1674). The port's adaptive
    RK45 and the dust diffusion are not in this copy (``scope.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..grid import Geometry
from ..params import Physics
from ..units import CGS_KB, CGS_AMU

@dataclass(frozen=True)
class ParticleState:
    """Struct-of-tensors particle state (polar coordinates, length N)."""
    r: torch.Tensor
    phi: torch.Tensor
    r_dot: torch.Tensor
    phi_dot: torch.Tensor
    size: torch.Tensor       # physical particle radius (code length units)
    stokes: torch.Tensor     # diagnostic: tstop * Omega_K
    alive: torch.Tensor      # escape mask (dead particles are frozen)
    # adaptive-integrator memory (reference src/particles/particle.h:5-40
    # carries per-particle timestep/facold across hydro steps); 0 = unset
    timestep: torch.Tensor
    facold: torch.Tensor
    # the diffusion kicks' generator on the swarm's device; not a tensor,
    # so no snapshot holds it: a restart re-seeds it, as the JAX package
    # re-seeds its key
    rng: torch.Generator | None = field(default=None, compare=False)

    def replace(self, **kw) -> "ParticleState":
        return replace(self, **kw)

    @property
    def n(self) -> int:
        return self.r.shape[0]


@dataclass(frozen=True)
class ParticleParams:
    """Static particle configuration (reference src/parameters.cpp dust
    section)."""
    density: float = 0.0          # internal particle density (code units)
    gas_drag: bool = True
    disk_gravity: bool = False
    diffusion: bool = False
    integrator: str = "midpoint"  # midpoint | explicit
    # integrate the adaptive RK45 in cartesian coordinates (reference
    # parameters.cpp:854-932 CartesianParticles; forced off for the
    # exponential-midpoint integrator, which is polar-only)
    cartesian: bool = False
    min_escape_radius: float = 0.0
    max_escape_radius: float = 1e300


# ---------------------------------------------------------------------------
# gas-field interpolation at particle positions
# ---------------------------------------------------------------------------

def _geometric_ladder(pos) -> tuple[float, float] | None:
    """(ln pos[0], 1/ln g) when the host array ``pos`` is a geometric
    ladder pos[i] = pos[0] * g^i (log radial grids), else None. Computed
    in float64 on the host."""
    p = np.asarray(pos, np.float64)
    if p.ndim != 1 or p.size < 2 or not np.all(p > 0.0):
        return None
    ratios = p[1:] / p[:-1]
    if np.ptp(ratios) > 1e-10 * ratios.mean():
        return None
    return float(np.log(p[0])), float(1.0 / np.log(ratios.mean()))


class RadialAxis(nn.Module):
    """The sorted radial sample points of a grid field's rows (cell centers
    or faces) as a buffer of the run dtype, with the ladder constants
    (Python floats) when the points are a geometric ladder."""

    def __init__(self, positions, dtype: torch.dtype,
                 device: torch.device | str | None = None):
        super().__init__()
        self.ladder = _geometric_ladder(positions)
        self.register_buffer("pos", torch.tensor(
            np.asarray(positions, np.float64), dtype=dtype, device=device))


class DustGrid(nn.Module):
    """What the particles read of the grid: the cell-center and the face
    radii and the azimuthal size."""

    def __init__(self, geometry: Geometry, dtype: torch.dtype,
                 device: torch.device | str | None = None):
        super().__init__()
        self.cell = RadialAxis(geometry.rmed, dtype, device)
        self.face = RadialAxis(geometry.radii, dtype, device)
        self.naz = geometry.naz


def _lin_weights(axis: RadialAxis, x):
    """Index pair + weights for linear interpolation on a sorted 1-D grid.

    The radial cell lookup is analytic on geometric ladders (log grids):
    i = floor((ln x - ln pos0) / ln g). A query on a cell edge can land one
    cell off the searchsorted answer through the rounding of log; the
    clamped weight then sits at 0 or 1, so the interpolated value stays
    continuous. Other grids take ``torch.searchsorted``."""
    pos = axis.pos
    n = pos.shape[0]
    if axis.ladder is not None:
        lr0, inv_lg = axis.ladder
        xs = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
        i = torch.floor((torch.log(xs) - lr0) * inv_lg).long()
    else:
        i = torch.searchsorted(pos, x) - 1
    i = torch.clamp(i, 0, n - 2)
    x0 = pos[i]
    x1 = pos[i + 1]
    w = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return i, w


def interpolate_many(fields, axis: RadialAxis | None, r, phi, naz,
                     az_offset=0.0, rw=None):
    """Bilinear interpolation of K same-layout grid fields at particle
    positions via takes from the flattened fields.

    ``axis`` holds the radial sample points of the fields' rows; azimuthal
    samples sit at (j + az_offset) dphi, periodic. ``rw`` optionally
    supplies the radial (index, weight) pair so callers sampling several
    field groups at the same rows compute it once. Every index is clamped
    or wrapped into the grid, whatever the position (a NaN included).
    Returns a tuple of K tensors."""
    dphi = 2.0 * math.pi / naz
    i, wr = rw if rw is not None else _lin_weights(axis, r)
    t = phi / dphi - az_offset
    j0f = torch.floor(t)
    wa = t - j0f
    j0 = torch.remainder(j0f.long(), naz)
    j1 = torch.remainder(j0 + 1, naz)
    row0 = i * naz
    row1 = row0 + naz
    outs = []
    for f in fields:
        ff = f.reshape(-1)
        f00 = torch.take(ff, row0 + j0)
        f01 = torch.take(ff, row0 + j1)
        f10 = torch.take(ff, row1 + j0)
        f11 = torch.take(ff, row1 + j1)
        outs.append((1 - wr) * ((1 - wa) * f00 + wa * f01)
                    + wr * ((1 - wa) * f10 + wa * f11))
    return tuple(outs)


def interpolate(field, axis, r, phi, naz, az_offset=0.0, rw=None):
    """Bilinear interpolation of one grid field at particle positions."""
    return interpolate_many((field,), axis, r, phi, naz,
                            az_offset=az_offset, rw=rw)[0]


class GasAtParticles(NamedTuple):
    rho: torch.Tensor
    temperature: torch.Tensor
    vg_r: torch.Tensor
    vg_phi: torch.Tensor     # inertial-frame azimuthal gas velocity


def sample_gas(grid: DustGrid, rho, temperature, vrad, vaz, omega_frame,
               r, phi) -> GasAtParticles:
    """Gas state at the particle positions (reference :1441-1470). The
    cell-centered radial weights (rho, T and vaz rows) are computed once
    and shared."""
    naz = grid.naz
    rw_cell = _lin_weights(grid.cell, r)
    rw_face = _lin_weights(grid.face, r)
    rho_p, T_p = interpolate_many((rho, temperature), None, r, phi, naz,
                                  az_offset=0.0, rw=rw_cell)
    vg_r = interpolate(vrad, None, r, phi, naz, az_offset=0.0, rw=rw_face)
    # v_az rows sample at azimuth (j-1/2) dphi (reference src/init.cpp:1552)
    vg_phi = interpolate(vaz, None, r, phi, naz, az_offset=-0.5, rw=rw_cell)
    vg_phi = vg_phi + omega_frame * r
    return GasAtParticles(rho=rho_p, temperature=T_p, vg_r=vg_r,
                          vg_phi=vg_phi)


# ---------------------------------------------------------------------------
# drag law
# ---------------------------------------------------------------------------

def calc_tstop(phys: Physics, constants, units, size, rho, vrel, temperature,
               particle_density):
    """Stopping time (reference src/particles/particles.cpp:1130-1215)."""
    m0 = phys.mu * (CGS_AMU / units.mass)
    k_B_code = CGS_KB / (units.energy / units.temperature)
    vthermal = torch.sqrt(8.0 * k_B_code * temperature / (math.pi * m0))
    a0 = 1.5e-8 / units.length                       # H2 radius in code units
    cross_section = math.pi * a0 ** 2
    nu_mol = (1.0 / 3.0) * m0 * vthermal / cross_section
    l_mfp = m0 / math.pi / a0 ** 2 / rho
    c_s = vthermal * math.sqrt(math.pi / 8.0)
    Kn = 0.5 * l_mfp / size
    vrel = torch.maximum(vrel, 1e-15 * c_s)
    Ma = vrel / c_s
    Re = 2.0 * size * rho * vrel / nu_mol
    CdE = 2.0 * torch.sqrt(Ma * Ma + 128.0 / (9.0 * math.pi))
    # Stokes drag coefficient branches (reference :1185-1195)
    cds_low = 24.0 * nu_mol / (2.0 * size * rho * c_s) \
        + 3.6 / c_s * vrel ** 0.687 * (2.0 * size * rho / nu_mol) ** -0.313
    cds_mid = 24.0 * Ma / Re + 3.6 * Ma * Re ** -0.313
    cds_high = Ma * 9.5e-5 * Re ** 1.397
    cds_max = Ma * 2.61
    CdS = torch.where(Re <= 1e-3, cds_low,
                      torch.where(Re <= 500.0, cds_mid,
                                  torch.where(Re <= 1500.0, cds_high,
                                              cds_max)))
    Cd = (9.0 * Kn * Kn * CdE + CdS) / (3.0 * Kn + 1.0) ** 2
    return 4.0 * l_mfp * particle_density / (3.0 * rho * Cd * c_s * Kn)


# ---------------------------------------------------------------------------
# gravity on particles
# ---------------------------------------------------------------------------

def gravity_derivatives(constants, bodies, n_bodies, r, phi):
    """(d(r_dot)/dt, d(l)/dt) from the N-body potential in polar
    coordinates about the grid origin (reference
    ``calculate_derivitives_from_star_and_planets``). The body scalars
    take the particles' dtype."""
    r_ddot = torch.zeros_like(r)
    l_dot = torch.zeros_like(r)
    G = constants.G
    for k in range(n_bodies):
        xk, yk, mk = (t[k].to(r.dtype)
                      for t in (bodies.x, bodies.y, bodies.mass))
        rk = torch.sqrt(xk * xk + yk * yk)
        phik = torch.atan2(yk, xk)
        cosd = torch.cos(phi - phik)
        sind = torch.sin(phi - phik)
        d2 = r * r + rk * rk - 2.0 * r * rk * cosd
        d3 = torch.clamp(d2, min=1e-300) ** 1.5
        r_ddot = r_ddot - G * mk * (r - rk * cosd) / d3
        l_dot = l_dot - G * mk * r * rk * sind / d3
    return r_ddot, l_dot


def sample_sg_accel(grid: DustGrid, sg_accel, r, phi):
    """Bilinear interpolation of the self-gravity acceleration fields at
    the particle positions (reference src/particles/particles.cpp:1506-1524
    ``update_velocity_from_disk_gravity``)."""
    g_r, g_t = sg_accel
    rpos = grid.cell.pos
    r_c = torch.minimum(torch.maximum(r, rpos[0]), rpos[-1])
    return interpolate_many((g_r, g_t), grid.cell, r_c, phi, g_r.shape[1])


def _finish(phys: Physics, pp: ParticleParams, constants,
            state: ParticleState, r3, phi3, r_dot3, phi_dot3, ts_physical,
            **extra) -> ParticleState:
    """The escape test and the freeze of the dead: ``alive`` only ever
    falls, and a dead particle keeps every value it had."""
    omega_k = torch.sqrt(constants.G * phys.hydro_center_mass / r3 ** 3)
    alive = state.alive & (r3 > pp.min_escape_radius) \
        & (r3 < pp.max_escape_radius)
    new = dict(r=r3, phi=phi3, r_dot=r_dot3, phi_dot=phi_dot3,
               stokes=ts_physical * omega_k, **extra)
    return state.replace(alive=alive, **{
        name: torch.where(alive, value, getattr(state, name))
        for name, value in new.items()})


# ---------------------------------------------------------------------------
# semi-implicit exponential midpoint integrator
# ---------------------------------------------------------------------------

def integrate_expmid(phys: Physics, pp: ParticleParams, constants, units,
                     grid: DustGrid, state: ParticleState,
                     rho, temperature, vrad, vaz, bodies, n_bodies,
                     omega_frame, dt, sg_accel=None) -> ParticleState:
    """One dt of particle motion (reference :1579-1674, Zhu et al. 2014).
    ``sg_accel`` = (g_r, g_phi) disk self-gravity grids enables disk
    gravity on the particles."""
    r0, phi0 = state.r, state.phi
    r_dot0, phi_dot0 = state.r_dot, state.phi_dot
    l0 = r0 * r0 * phi_dot0
    hfdt = 0.5 * dt

    # half-drift
    r1 = r0 + r_dot0 * hfdt
    phi1 = phi0 + 0.5 * (l0 / r0 ** 2 + l0 / r1 ** 2) * hfdt

    # kick: the stopping time is computed even with drag disabled, for the
    # Stokes number (reference ``check_tstop``, :1548-1551)
    gas = sample_gas(grid, rho, temperature, vrad, vaz, omega_frame, r1,
                     phi1)
    vrel_r = gas.vg_r - r_dot0
    l_gas = r1 * gas.vg_phi
    vrel_phi = (l_gas - l0) / r1
    vrel = torch.sqrt(vrel_r ** 2 + vrel_phi ** 2)
    ts_physical = calc_tstop(phys, constants, units, state.size, gas.rho,
                             vrel, gas.temperature, pp.density)
    if pp.gas_drag:
        ts = ts_physical
    else:
        # 1e100 is infinite in float32, as in the JAX package
        ts = torch.full_like(r0, 1e100, dtype=torch.float64).to(r0.dtype)
        vrel_r = torch.zeros_like(r0)
        l_gas = l0

    r_ddot_grav, l_dot_grav = gravity_derivatives(constants, bodies,
                                                  n_bodies, r1, phi1)
    if pp.disk_gravity and sg_accel is not None:
        sg_r, sg_t = sample_sg_accel(grid, sg_accel, r1, phi1)
        r_ddot_grav = r_ddot_grav + sg_r
        l_dot_grav = l_dot_grav + r1 * sg_t

    # exponential propagator (Mignone et al. 2019 eq. 33)
    x = dt / ts
    exp_ts = torch.exp(-x)
    h1 = ts * -torch.expm1(-x)

    l2 = exp_ts * l0 + h1 * l_dot_grav
    if pp.gas_drag:
        l2 = l2 + h1 * l_gas / ts

    r_dot2 = exp_ts * r_dot0
    r_dot2 = r_dot2 + h1 * 0.5 * (l0 * l0 + l2 * l2) / r1 ** 3
    r_dot2 = r_dot2 + h1 * r_ddot_grav
    if pp.gas_drag:
        v_r_g = vrel_r + r_dot0
        r_dot2 = r_dot2 + h1 * v_r_g / ts

    # half-drift
    r3 = r1 + r_dot2 * hfdt
    phi3 = phi1 + 0.5 * (l2 / r1 ** 2 + l2 / r3 ** 2) * hfdt
    phi3 = torch.remainder(phi3, 2.0 * math.pi)
    return _finish(phys, pp, constants, state, r3, phi3, r_dot2,
                   l2 / r3 ** 2, ts_physical)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_particles(n: int, rmin: float, rmax: float, slope: float,
                   sizes, GM: float, eccentricity: float = 0.0,
                   seed: int = 1337, dtype: torch.dtype = torch.float64,
                   device: torch.device | str | None = None,
                   radii_explicit=None) -> ParticleState:
    """Particles on near-Keplerian orbits with a power-law radial
    distribution (reference src/particles/particles.cpp:516-723). The draw
    is numpy's on the host, the JAX package's draw for the same seed; the
    diffusion's generator starts from the same seed."""
    rng = np.random.default_rng(seed)
    if radii_explicit is not None:
        r = np.asarray(radii_explicit, np.float64)
    else:
        # inverse-CDF sampling of dN/dr ~ r^-slope on [rmin, rmax]
        u_ = rng.random(n)
        if abs(slope - 1.0) < 1e-12:
            r = rmin * (rmax / rmin) ** u_
        else:
            p = 1.0 - slope
            r = (rmin ** p + u_ * (rmax ** p - rmin ** p)) ** (1.0 / p)
    phi = rng.random(n) * 2.0 * np.pi
    ecc = rng.random(n) * eccentricity
    v_k = np.sqrt(GM / r)
    # start at apocenter of the eccentric orbit
    vphi = v_k * np.sqrt(np.maximum(1.0 - ecc, 0.0) / (1.0 + ecc))
    sizes = np.broadcast_to(np.asarray(sizes, np.float64), (n,))

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    return ParticleState(
        r=t(r), phi=t(phi), r_dot=t(np.zeros(n)), phi_dot=t(vphi / r),
        size=t(sizes), stokes=t(np.zeros(n)),
        alive=torch.ones(n, dtype=torch.bool, device=device),
        timestep=t(np.zeros(n)), facold=t(np.full(n, 1e-4)),
        rng=torch.Generator(device=device or "cpu").manual_seed(seed))

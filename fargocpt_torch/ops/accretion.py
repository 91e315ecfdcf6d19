"""Accretion of gas onto planets (reference src/accretion.cpp; the JAX
package's ``ops/accretion.py`` on tensors).

Three variants, per body: Kley's two-zone Hill-sphere accretion (:84-222),
a fraction f_acc of the mass inside frac * R_Hill removed per orbital
period (log-2 normalized), the inner zone twice as hard; the single-zone
sinkhole (:223-335); and the viscous rate Mdot = 3 pi nu Sigma spread over
the zone (:336-481). The removed mass and momentum go to the body when
disk feedback is on. Every update is a masked pass over the grid and every
sum stays on the device: the bodies' new masses and velocities are
tensors, read by no host code.
"""

from __future__ import annotations

import math

import torch

from ..nbody import system as nbody_sys
from ..params import Physics
from .common import Geom, azim_next, ring_col

VARIANTS = ("kley", "sinkhole", "viscous")


def orbital_periods(constants, nb: nbody_sys.NBodyState,
                    n_hydroframe: int = 1) -> torch.Tensor:
    """Osculating orbital period of every body (float64), as the
    reference stores it (src/nbody/planetary_system.cpp:773-800 +
    src/nbody/planet.cpp:488-566): body k about the centre of mass of
    bodies 0..k-1 with mu = G (inner masses + its own), a = h^2 / (mu (1 -
    e^2)) from the Laplace-Runge-Lenz eccentricity. Body 0 gets 0 when it
    alone defines the hydro frame, and in a two-body system the primary
    takes the secondary's period. The leapfrog samples these once, after
    its first half drift, for both accretion halves."""
    m = nb.mass
    n = m.shape[0]
    mass_in = torch.cumsum(m, 0) - m
    inner = mass_in > 0.0
    denom = torch.where(inner, mass_in, torch.ones_like(mass_in))

    def com(q):
        s = torch.cumsum(m * q, 0) - m * q
        return torch.where(inner, s / denom, torch.zeros_like(s))

    x = nb.x - com(nb.x)
    y = nb.y - com(nb.y)
    vx = nb.vx - com(nb.vx)
    vy = nb.vy - com(nb.vy)
    mu = constants.G * (mass_in + m)
    h = x * vy - y * vx
    d = torch.sqrt(x * x + y * y)
    d_safe = torch.where(d > 0.0, d, torch.ones_like(d))
    ax_lrl = x * vy * vy - y * vx * vy - mu * x / d_safe
    ay_lrl = y * vx * vx - x * vx * vy - mu * y / d_safe
    e = torch.sqrt(ax_lrl * ax_lrl + ay_lrl * ay_lrl) / mu
    one_m_e2 = 1.0 - e * e
    a = h * h / mu / torch.where(one_m_e2 != 0.0, one_m_e2,
                                 torch.ones_like(one_m_e2))
    valid = (d > 0.0) & (h != 0.0) & (e <= 1.0) & (a > 0.0)
    period = torch.where(valid,
                         2.0 * math.pi * torch.sqrt(torch.abs(a) ** 3 / mu),
                         torch.zeros_like(a))
    if n_hydroframe == 1:
        period = torch.cat([torch.zeros_like(period[:1]), period[1:]])
    if n == 2:
        period = torch.cat([period[1:], period[1:]])
    return period


def accrete_onto_planets(phys: Physics, constants, g: Geom,
                         nb: nbody_sys.NBodyState, efficiency: torch.Tensor,
                         types: list[str], cell_x, cell_y, sigma, energy,
                         vrad, vaz, omega_frame, dt, nu_grid=None,
                         periods=None, row_w=None, comm=None):
    """Accretion by every accreting body (``types[k]`` one of
    ``VARIANTS``; ``efficiency`` the (N,) accretion efficiencies in the
    field type). ``nu_grid`` is the viscosity grid the viscous variant
    reads; ``periods`` the orbital periods sampled at the last drift
    (``orbital_periods(constants, nb)`` when None). Returns (sigma,
    energy, nb), the bodies' masses and velocities updated when disk
    feedback is on (reference :200-219). ``row_w`` (NR, 1) weights the rows
    whose mass the bodies gain, 2..NR-2 when None; sharded, the window's
    owned rows of them, and ``comm`` sums each body's gains over the ranks
    (fargocpt_tpu/ops/accretion.py:195-203)."""
    dtype = sigma.dtype
    floor = phys.sigma_floor * phys.sigma0
    # cell-centred cartesian gas velocities (reference :155-161)
    vt_cell = 0.5 * (vaz + azim_next(vaz)) + g.rb * omega_frame.to(dtype)
    vr_cell = 0.5 * (vrad[:-1] + vrad[1:])
    vx_cell = (vr_cell * cell_x - vt_cell * cell_y) * g.inv_rb
    vy_cell = (vr_cell * cell_y + vt_cell * cell_x) * g.inv_rb
    # the rows whose mass the bodies gain (reference :172-176: rows 2 to
    # NR - 2 in the serial layout)
    row_w = ring_col(g, 2) if row_w is None else row_w

    if periods is None:
        periods = orbital_periods(constants, nb)
    r_hill_all = nbody_sys.dimensionless_roche_radius(nb) \
        * nbody_sys.dist_to_primary(nb)
    mass, vx, vy = nb.mass, nb.vx, nb.vy
    zero = torch.zeros((), dtype=dtype, device=sigma.device)

    for k, kind in enumerate(types):
        if kind not in VARIANTS:
            continue
        r_hill = r_hill_all[k].to(dtype)
        dx = nb.x[k].to(dtype) - cell_x
        dy = nb.y[k].to(dtype) - cell_y
        dist = torch.sqrt(dx * dx + dy * dy)
        facc_max = 1.0 - floor / sigma
        if kind in ("kley", "sinkhole"):
            facc = (dt * efficiency[k] / periods[k] * math.log(2.0)).to(dtype)
        if kind == "kley":
            facc1 = facc / 3.0
            facc2 = 2.0 * facc / 3.0
            zone1 = dist < phys.accretion_radius_fraction * r_hill
            zone2 = dist < 0.5 * phys.accretion_radius_fraction * r_hill
            # the outer zone, then the inner one on the reduced density; the
            # reference caps the inner zone with the pre-zone-1 facc_max and
            # scales its energy by the uncapped facc2 (reference :183-198)
            f1 = torch.where(zone1, torch.minimum(facc1, facc_max), zero)
            dm1 = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)
            f2 = torch.where(zone2, torch.minimum(facc2, facc_max), zero)
            dm2 = f2 * sigma * g.surf
            sigma = sigma * (1.0 - f2)
            if phys.is_adiabatic:
                energy = energy * torch.where(zone2, 1.0 - facc2,
                                              torch.ones_like(facc2))
            dm = dm1 + dm2
        elif kind == "sinkhole":
            zone = dist < phys.accretion_radius_fraction * r_hill
            f1 = torch.where(zone, torch.minimum(facc, facc_max), zero)
            dm = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)
        else:
            if nu_grid is None:
                continue
            facc = dt * 3.0 * math.pi * efficiency[k]
            dist_max = phys.accretion_radius_fraction * r_hill
            if phys.visc_accret_massflow_test:
                # ViscAccretMassflowTest's normalization, its d^2 / 6 first
                # term as the reference has it (:360-371); RMIN = Ra[1]
                rmin = g.ra[1, 0]
                area = 2.0 * math.pi * (
                    (0.5 * dist_max ** 2 - dist_max ** 2 / 3.0)
                    - (0.5 * rmin ** 2 - rmin ** 3 / (3.0 * dist_max)))
                f_const = 1.0 / area
            else:
                f_const = 3.0 / math.pi / dist_max ** 2
            spread = f_const * (1.0 - dist / dist_max)
            zone = dist < dist_max
            f1 = torch.where(zone, torch.minimum(facc * nu_grid * spread,
                                                 facc_max), zero)
            dm = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)

        dm = dm * row_w
        d_m = torch.sum(dm)
        d_px = torch.sum(dm * vx_cell)
        d_py = torch.sum(dm * vy_cell)
        if comm is not None:
            d_m, d_px, d_py = comm.sum(torch.stack([d_m, d_px, d_py]))
        if phys.disk_feedback or phys.accrete_without_disk_feedback:
            # reference accretion.cpp:207, 319, 466
            m_new = mass[k] + d_m
            vx = _set(vx, k, (mass[k] * vx[k] + d_px) / m_new)
            vy = _set(vy, k, (mass[k] * vy[k] + d_py) / m_new)
            mass = _set(mass, k, m_new)

    return sigma, energy, nb.replace(mass=mass, vx=vx, vy=vy)


def _set(t: torch.Tensor, k: int, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with element ``k`` set to ``value``, on the
    device."""
    out = t.clone()
    out[k] = value
    return out

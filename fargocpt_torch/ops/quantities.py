"""Disk monitor diagnostics (reference src/quantities.cpp): the scalars of
one monitor/Quantities.dat row, the instantaneous torque increments
(src/gas_torques.cpp) and the per-cell fields of the ``Write*`` snapshot
outputs. The JAX package's ``ops/quantities.py`` on tensors; every
reduction runs over the active rings (rows 1..NR-2) on the fields' device.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry
from ..params import Physics
from .common import Geom, accurate_cos, azim_next, azim_prev, ring_col


def _active(x, nr):
    return x[1:nr - 1]


def _mask_cols(g: Geom, radius_limit):
    return g.rb[1:g.nrad - 1] <= radius_limit


def total_mass(phys: Physics, g: Geom, sigma, radius_limit, row_w=None,
               comm=None):
    """reference src/quantities.cpp:51-80. ``row_w`` (NR, 1) weights the
    rows: the active rings 1..NR-2 when None; sharded, the window's owned
    active rows, and ``comm`` sums over the ranks
    (fargocpt_tpu/ops/quantities.py:27-38)."""
    row_w = ring_col(g, 1) if row_w is None else row_w
    w = torch.where(g.rb <= radius_limit, g.surf, 0.0) * row_w
    s = torch.sum(w * sigma)
    return comm.sum(s) if comm is not None else s


def disk_radius(phys: Physics, g: Geom, sigma, total, frac: float = 0.99):
    """Radius containing ``frac`` of the mass
    (reference src/quantities.cpp:191-240)."""
    nr = g.nrad
    ring_mass = torch.sum(_active(sigma, nr) * g.surf[1:nr - 1], dim=-1)
    cum = torch.cumsum(ring_mass, dim=0)
    idx = torch.searchsorted(cum, (frac * total).reshape(1))[0]
    idx = torch.clamp(idx, 0, nr - 3)
    telemetry.count("sync.monitor.disk_radius")
    return g.rb[1 + idx, 0]


def angular_momentum(phys: Physics, g: Geom, sigma, vaz, omega_frame,
                     radius_limit):
    """reference src/quantities.cpp:242-279."""
    nr = g.nrad
    sig_avg = 0.5 * (sigma + azim_prev(sigma))
    cell = g.surf * sig_avg * g.rb * (vaz + omega_frame * g.rb)
    w = torch.where(_mask_cols(g, radius_limit), _active(cell, nr), 0.0)
    return torch.sum(w)


def internal_energy(phys: Physics, g: Geom, energy, radius_limit):
    nr = g.nrad
    w = torch.where(_mask_cols(g, radius_limit), g.surf[1:nr - 1], 0.0)
    return torch.sum(w * _active(energy, nr))


def _cell_center_velocities(g: Geom, vrad, vaz, omega_frame):
    vr_c = ((g.rb - g.rinf) * vrad[1:] + (g.rsup - g.rb) * vrad[:-1]) \
        / (g.rsup - g.rinf)
    vaz_c = 0.5 * (vaz + azim_next(vaz))
    return vr_c, vaz_c


def kinetic_energies(phys: Physics, g: Geom, sigma, vrad, vaz, omega_frame,
                     radius_limit):
    """(radial, azimuthal) kinetic energy
    (reference src/quantities.cpp:357-480). The azimuthal part includes the
    frame rotation."""
    nr = g.nrad
    vr_c, vaz_c = _cell_center_velocities(g, vrad, vaz, omega_frame)
    vaz_tot = vaz_c + omega_frame * g.rb
    w = torch.where(_mask_cols(g, radius_limit),
                    (0.5 * g.surf * sigma)[1:nr - 1], 0.0)
    e_rad = torch.sum(w * _active(vr_c, nr) ** 2)
    e_az = torch.sum(w * _active(vaz_tot, nr) ** 2)
    return e_rad, e_az


def potential_energy(phys: Physics, constants, g: Geom, sigma, pot,
                     radius_limit):
    nr = g.nrad
    w = torch.where(_mask_cols(g, radius_limit), g.surf[1:nr - 1], 0.0)
    return torch.sum(w * _active(sigma * pot, nr))


def eccentricity_vector(phys: Physics, constants, g: Geom, sigma, vrad, vaz,
                        omega_frame, frame_angle, cos_phi, sin_phi):
    """Per-cell Runge-Lenz vector rotated to the inertial frame
    (reference src/quantities.cpp:481-551)."""
    total_mass_cell = phys.hydro_center_mass + sigma * g.surf
    r_x = g.rb * cos_phi
    r_y = g.rb * sin_phi
    vr_c = 0.5 * (vrad[:-1] + vrad[1:])
    vaz_c = 0.5 * (vaz + azim_next(vaz)) + omega_frame * g.rb
    v_x = cos_phi * vr_c - sin_phi * vaz_c
    v_y = sin_phi * vr_c + cos_phi * vaz_c
    dist = g.rb
    j = r_x * v_y - r_y * v_x
    gm = constants.G * total_mass_cell
    e_x = j * v_y / gm - r_x / dist
    e_y = -j * v_x / gm - r_y / dist
    ca = accurate_cos(frame_angle)
    sa = torch.sin(frame_angle)
    return e_x * ca - e_y * sa, e_y * ca + e_x * sa


def mass_average(phys: Physics, g: Geom, sigma, arr, radius_limit,
                 row_w=None, comm=None):
    """reference src/quantities.cpp:107-190; ``row_w`` and ``comm`` as
    ``total_mass`` takes them."""
    row_w = ring_col(g, 1) if row_w is None else row_w
    w = torch.where(g.rb <= radius_limit, sigma * g.surf, 0.0) * row_w
    num_den = torch.stack([torch.sum(w * arr), torch.sum(w)])
    if comm is not None:
        num_den = comm.sum(num_den)
    return num_den[0] / num_den[1]


def disk_ecc_peri(phys: Physics, constants, g: Geom, sigma, vrad, vaz,
                  omega_frame, frame_angle, cos_phi, sin_phi, radius_limit,
                  row_w=None, comm=None):
    e_x, e_y = eccentricity_vector(phys, constants, g, sigma, vrad, vaz,
                                   omega_frame, frame_angle, cos_phi, sin_phi)
    ax = mass_average(phys, g, sigma, e_x, radius_limit, row_w, comm)
    ay = mass_average(phys, g, sigma, e_y, radius_limit, row_w, comm)
    return torch.sqrt(ax * ax + ay * ay), torch.atan2(ay, ax)


@telemetry.spanned("quantities.toomre_q")
def toomre_q(phys: Physics, constants, g: Geom, sigma, cs):
    """Toomre Q = cs * Omega_K / (pi G Sigma) per cell
    (reference src/compute.cpp:93-113 ``toomreQ``)."""
    omega_k = torch.sqrt(constants.G * phys.hydro_center_mass / g.rb ** 3)
    return cs * omega_k / (math.pi * constants.G * sigma)


def reynolds_stress(g: Geom, sigma, vrad, vaz):
    """T_Reynolds = Sigma (v_r,c - <v_r,c>_phi)(v_phi,c - <v_phi,c>_phi)
    (reference src/stress.cpp:34-71 ``calculate_Reynolds_stress``; cell
    centering by plain face averaging as there)."""
    vr_c = 0.5 * (vrad[:-1] + vrad[1:])
    va_c = 0.5 * (vaz + azim_next(vaz))
    dvr = vr_c - torch.mean(vr_c, dim=-1, keepdim=True)
    dva = va_c - torch.mean(va_c, dim=-1, keepdim=True)
    return sigma * dvr * dva


def gravitational_stress(phys: Physics, constants, g: Geom, g_r, g_t):
    """T_grav = g_r g_phi (2 h_ref R) / (4 pi G) from the self-gravity
    acceleration fields (reference src/stress.cpp:11-32)."""
    return (1.0 / (4.0 * math.pi * constants.G) * g_r * g_t
            * 2.0 * phys.aspectratio_ref * g.rb)


def alpha_from_stress(stress, sigma, cs):
    """alpha(R) = (2/3) T / (Sigma cs^2)
    (reference src/quantities.cpp:601-706 calculate_alpha_{grav,reynolds})."""
    return (2.0 / 3.0) * stress / (sigma * cs * cs)


def circumplanetary_mass(constants, g: Geom, sigma, cell_x, cell_y,
                         body_x, body_y, roche_radius):
    """Gas mass inside one body's Roche lobe over the active rings
    (reference src/circumplanetary_mass.cpp:11-50)."""
    nr = g.nrad
    dist = torch.sqrt((cell_x - body_x) ** 2 + (cell_y - body_y) ** 2)
    w = torch.where(dist < roche_radius, g.surf * sigma, 0.0)
    return torch.sum(w[1:nr - 1])


def advection_torque_increment(g: Geom, sigma, vrad, vaz, dt):
    """-r^2 Sigma v_r,c v_phi,c dt per cell (reference
    src/gas_torques.cpp:11-44 ``calculate_advection_torque``)."""
    vr_c = ((g.rb - g.rinf) * vrad[1:] + (g.rsup - g.rb) * vrad[:-1]) \
        * g.inv_diff_rsup
    va_c = 0.5 * (vaz + azim_next(vaz))
    return -g.rb ** 2 * sigma * vr_c * va_c * dt


def viscous_torque_increment(g: Geom, sigma, nu, vrad, vaz, dt):
    """-r^3 nu Sigma (d(phi_dot)/dr + dvr/dphi / r^2) dt, rows 1..NR-2
    (reference src/gas_torques.cpp:46-117 ``calculate_viscous_torque``)."""
    nr = g.nrad
    dvr_dphi_face = (azim_next(vrad) - azim_prev(vrad)) * 0.5 * g.invdphi
    dvr_dphi = ((g.rb - g.rinf) * dvr_dphi_face[1:]
                + (g.rsup - g.rb) * dvr_dphi_face[:-1]) * g.inv_diff_rsup
    phi_dot = 0.5 * (vaz + azim_next(vaz)) * g.inv_rb       # (NR, NAZ)
    dpd_top = (phi_dot[2:] - phi_dot[1:-1]) * g.inv_diff_rmed[2:nr]
    dpd_bot = (phi_dot[1:-1] - phi_dot[:-2]) * g.inv_diff_rmed[1:nr - 1]
    mid = slice(1, nr - 1)
    dphi_dot_dr = ((g.rb - g.rinf)[mid] * dpd_top
                   + (g.rsup - g.rb)[mid] * dpd_bot) * g.inv_diff_rsup[mid]
    t_mid = -g.rb[mid] ** 3 * (nu * sigma)[mid] * \
        (dphi_dot_dr + dvr_dphi[mid] * g.inv_rb[mid] ** 2) * dt
    z = torch.zeros_like(sigma[:1])
    return torch.cat([z, t_mid, z], dim=0)


def gravitational_torque_increment(g: Geom, sigma, pot, dt):
    """-Sigma dPhi/dphi Surf dt (Miranda 2017 eq. 32; reference
    src/gas_torques.cpp:119-155, potential-based branch)."""
    gradphi = (azim_next(pot) - azim_prev(pot)) * g.invdphi * 0.5
    return -sigma * gradphi * g.surf * dt


def radial_luminosity(g: Geom, qminus):
    """L(r) = sum_phi Qminus R dr dphi per ring
    (reference src/quantities.cpp:712-743 ``calculate_radial_luminosity``)."""
    return torch.sum(qminus * g.rb * (g.rsup - g.rinf) * g.dphi, dim=-1)


def radial_dissipation(g: Geom, qplus):
    """reference src/quantities.cpp:744-769."""
    return torch.sum(qplus * g.rb * (g.rsup - g.rinf) * g.dphi, dim=-1)


def monitor_quantities(phys: Physics, constants, g: Geom, sigma, vrad, vaz,
                       energy, pot, qplus, qminus, omega_frame, frame_angle,
                       cos_phi, sin_phi, radius_limit):
    """All scalars for one Quantities.dat row, as a dict of 0-d tensors."""
    nr = g.nrad
    mass = total_mass(phys, g, sigma, radius_limit)
    radius = disk_radius(phys, g, sigma, mass,
                         frac=phys.disk_radius_mass_fraction)
    am = angular_momentum(phys, g, sigma, vaz, omega_frame, radius_limit)
    eint = internal_energy(phys, g, energy, radius_limit)
    e_rad, e_az = kinetic_energies(phys, g, sigma, vrad, vaz, omega_frame,
                                   radius_limit)
    epot = potential_energy(phys, constants, g, sigma, pot, radius_limit)
    ecc, peri = disk_ecc_peri(phys, constants, g, sigma, vrad, vaz,
                              omega_frame, frame_angle, cos_phi, sin_phi,
                              radius_limit)
    w = torch.where(_mask_cols(g, radius_limit), g.surf[1:nr - 1], 0.0)
    dissipation = torch.sum(w * _active(qplus, nr))
    luminosity = torch.sum(w * _active(qminus, nr))
    return {
        "mass": mass, "radius": radius, "angular momentum": am,
        "internal energy": eint, "radial kinetic energy": e_rad,
        "azimuthal kinetic energy": e_az,
        "kinematic energy": e_rad + e_az,
        "potential energy": epot,
        "total energy": eint + e_rad + e_az + epot,
        "eccentricity": ecc, "periastron": peri,
        "viscous dissipation": dissipation, "luminosity": luminosity,
    }

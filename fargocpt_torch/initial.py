"""Initial conditions (reference src/init.cpp): the power-law disk
(init_gas_density :937, init_gas_energy :1257, init_gas_velocities
:1467), the spreading-ring test (:346-415), the Sod shock tube with the
ideal gas (:425-443) and with PVTE (:525-540), the pure Keplerian start,
the disk-mass renormalisation ``SetSigma0`` (:1150-1188), the 1-d / 2-d
profile files of ``SigmaCondition`` / ``EnergyCondition``, the
N-body-centred conditions (``nbody``), the circumbinary ring, the binary
quadrupole support of v_az, the simplex-noise ``RandomSigma``
(:1015-1060), the disk around the secondary (:624-888) and the
``CentrifugalBalance`` v_az (:1638-1717).

Everything is built host-side in float64 numpy, seeded noise included, and
cast to the run dtype on the target device.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import Constants
from .grid import Geometry
from .ops import diskmodel as dm
from .params import Physics
from .state import FieldState


def powerlaw_sigma(phys: Physics, geom: Geometry) -> np.ndarray:
    """Sigma = Sigma0 r^-slope with floor and optional profile cutoffs
    (reference src/init.cpp:937-1124)."""
    r = geom.rmed[:, None]
    sigma = phys.sigma0 * r ** (-phys.sigma_slope)
    if phys.profile_cutoff_outer:
        sigma = sigma * dm.cutoff_outer(phys.profile_cutoff_point_outer,
                                        phys.profile_cutoff_width_outer, r)
    if phys.profile_cutoff_inner:
        sigma = sigma * dm.cutoff_inner(phys.profile_cutoff_point_inner,
                                        phys.profile_cutoff_width_inner, r)
    sigma = np.maximum(sigma, phys.sigma_floor * phys.sigma0)
    return np.broadcast_to(sigma, (geom.nrad, geom.naz)).copy()


def powerlaw_energy(phys: Physics, constants: Constants,
                    geom: Geometry, sigma: np.ndarray) -> np.ndarray:
    """reference src/init.cpp:1257-1302 with the temperature floor and the
    profile-cutoff damping of the energy (init.cpp:1364-1443)."""
    r = geom.rmed[:, None]
    energy = dm.initial_energy(phys, constants, r, phys.hydro_center_mass)
    e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
        / (phys.adiabatic_index - 1.0)
    energy = np.maximum(np.broadcast_to(energy, sigma.shape), e_floor)
    if phys.profile_cutoff_outer:
        fac = np.asarray(dm.cutoff_outer(phys.profile_cutoff_point_outer,
                                         phys.profile_cutoff_width_outer, r))
        energy = np.maximum(energy * fac, e_floor)
    if phys.profile_cutoff_inner:
        fac = np.asarray(dm.cutoff_inner(phys.profile_cutoff_point_inner,
                                         phys.profile_cutoff_width_inner, r))
        energy = np.maximum(energy * fac, e_floor)
    return energy


def gas_velocities(phys: Physics, constants: Constants, geom: Geometry,
                   quad_moment: float = 0.0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Axisymmetric velocity ICs (reference src/init.cpp:1467-1780,
    single-star primary-frame branch). ``quad_moment`` adds the binary
    quadrupole support to v_az (reference src/Theo.cpp:183-205)."""
    G = constants.G
    M = phys.hydro_center_mass
    rb = geom.rmed
    ri = geom.rinf
    if phys.initialize_pure_keplerian:
        # the reference takes Rmed for the v_rad rows too
        # (src/init.cpp:1611-1632)
        vaz_row = np.sqrt(G * M / rb)
        vr_row = dm.viscous_radial_speed_analytic(phys, constants, rb, M)
        vaz = np.broadcast_to((vaz_row - phys.omega_frame * rb)[:, None],
                              (geom.nrad, geom.naz)).copy()
        vr_full = np.zeros((geom.nrad + 1, geom.naz))
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
        return vr_full, vaz
    vaz_row = dm.v_az_smoothed(phys, constants, rb, M, quad_moment) \
        - phys.omega_frame * rb
    vaz = np.broadcast_to(vaz_row[:, None], (geom.nrad, geom.naz)).copy()
    vr_full = np.zeros((geom.nrad + 1, geom.naz))
    if not phys.initialize_vradial_zero:
        # the numerical drift of the initial profile, cutoffs included
        # (src/init.cpp:1766 get_vr_with_numerical_viscous_speed)
        vr_row = dm.vr_numerical_viscous(phys, constants, ri, M,
                                         quad_moment)
        if phys.imposed_disk_drift != 0.0:
            sigma_inf = phys.sigma0 * ri ** (-phys.sigma_slope)
            vr_row = vr_row + phys.imposed_disk_drift * phys.sigma0 \
                / sigma_inf / ri
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
    return vr_full, vaz


SPREADING_RING_R0 = 1.0
SPREADING_RING_TAU0 = 0.016


def _spreading_ring_profile(phys: Physics, x):
    """Speith & Kley 2003: Sigma(x) = M / (pi R0^2 tau0) x^-1/4
    I_{1/4}(2x / tau0) exp(-(1 + x^2) / tau0)."""
    from scipy.special import iv as bessel_iv
    tau0 = SPREADING_RING_TAU0
    return phys.sigma_diskmass / (np.pi * SPREADING_RING_R0 ** 2) \
        / (tau0 * x ** 0.25) * bessel_iv(0.25, 2.0 * x / tau0) \
        * np.exp(-(1.0 + x ** 2) / tau0)


def spreading_ring_sigma(phys: Physics, geom: Geometry) -> np.ndarray:
    """The viscously spreading ring (reference src/init.cpp:352-415),
    floored at SigmaFloor times its value in the cell holding R0
    (:361-380)."""
    r0 = SPREADING_RING_R0
    sigma = _spreading_ring_profile(phys, geom.rmed / r0)
    idx = np.nonzero((geom.rsup > r0) & (geom.rinf < r0))[0]
    r_peak = geom.rmed[idx[0]] if idx.size else geom.rmed[0]
    floor = _spreading_ring_profile(phys, r_peak / r0) * phys.sigma_floor
    sigma = np.maximum(sigma, floor)
    return np.broadcast_to(sigma[:, None], (geom.nrad, geom.naz)).copy()


def shock_tube_fields(geom: Geometry, pvte: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Sod shock tube (reference src/init.cpp:425-443, the PVTE tube
    :525-540): left Sigma 1, right 0.125, the jump half a unit above the
    innermost cell centre; the energies (2.5, 0.25) of the ideal gas or
    the PVTE tube's (10.3616..., 0.9110...). Returns (sigma, energy)."""
    right = (geom.rmed - geom.rmed[0]) > 0.5
    sig = np.where(right, 0.125, 1.0)
    if pvte:
        en = np.where(right, 0.9110851732216827, 10.361627466581034)
    else:
        en = np.where(right, 2.0 * 0.125, 2.5)
    shape = (geom.nrad, geom.naz)
    return (np.broadcast_to(sig[:, None], shape).copy(),
            np.broadcast_to(en[:, None], shape).copy())


def renormalize_sigma(phys: Physics, geom: Geometry, sigma: np.ndarray,
                      energy: np.ndarray):
    """SetSigma0: rescale so the active rings hold DiskMass (reference
    src/init.cpp:1150-1188). Returns (sigma, energy, new_sigma0)."""
    surf = geom.surf[:, None]
    total = float(np.sum(sigma[1:-1] * surf[1:-1]))
    factor = phys.sigma_diskmass / total
    sigma = sigma * factor
    if phys.is_adiabatic:
        energy = energy * factor
    return sigma, energy, phys.sigma0 * factor


_GRAD2 = np.array([[1, 1], [-1, 1], [1, -1], [-1, -1],
                   [1, 0], [-1, 0], [0, 1], [0, -1]], np.float64)


def simplex_noise_2d(x: np.ndarray, y: np.ndarray, seed: int) -> np.ndarray:
    """2-D simplex gradient noise (Perlin 2001) in [-1, 1], the
    permutation drawn by numpy from ``seed``. It stands in for the
    reference's vendored open-simplex port (src/open-simplex-noise.cpp):
    band-limited, smooth and zero-mean like it, with other values; the
    JAX package draws the same field (fargocpt_tpu/initial.py:197-235)."""
    f2 = 0.5 * (np.sqrt(3.0) - 1.0)
    g2 = (3.0 - np.sqrt(3.0)) / 6.0
    perm = np.tile(np.random.default_rng(seed).permutation(256), 2)
    s = (x + y) * f2
    i = np.floor(x + s).astype(np.int64)
    j = np.floor(y + s).astype(np.int64)
    t = (i + j) * g2
    x0 = x - (i - t)
    y0 = y - (j - t)
    i1 = (x0 > y0).astype(np.int64)
    j1 = 1 - i1
    x1 = x0 - i1 + g2
    y1 = y0 - j1 + g2
    x2 = x0 - 1.0 + 2.0 * g2
    y2 = y0 - 1.0 + 2.0 * g2
    ii = i & 255
    jj = j & 255

    def corner(xs, ys, gi):
        tt = np.maximum(0.5 - xs * xs - ys * ys, 0.0)
        g = _GRAD2[gi % 8]
        return tt ** 4 * (g[..., 0] * xs + g[..., 1] * ys)

    n0 = corner(x0, y0, perm[ii + perm[jj]])
    n1 = corner(x1, y1, perm[ii + i1 + perm[jj + j1]])
    n2 = corner(x2, y2, perm[ii + 1 + perm[jj + 1]])
    return 70.0 * (n0 + n1 + n2)


def randomize_sigma(phys: Physics, geom: Geometry,
                    sigma: np.ndarray) -> np.ndarray:
    """RandomSigma: Sigma times (1 + RandomFactor noise), the noise 11
    octaves of simplex noise over the cells' Cartesian centres, octave i
    seeded with RandomSeed + i (reference src/init.cpp:1015-1060)."""
    x, y = geom.cell_centers_xy()
    f = phys.sigma_feature_size
    order = 11
    noise = np.zeros_like(x)
    for i in range(order):
        feature = float(1 << i)
        weight = float(1 << (order - i - 1))
        noise += weight * simplex_noise_2d(feature * x / f, feature * y / f,
                                           phys.random_seed + i)
    noise /= float((1 << order) - 1)
    return sigma * (1.0 + phys.sigma_random_factor * noise)


def read_1d_profile(path: str, radii: np.ndarray) -> np.ndarray:
    """A binary 1-d profile ([radius, value] rows, or the written [radius,
    avg, min, max]) cubic-splined onto ``radii`` (reference
    src/polargrid.cpp:360-470 ``read1D``)."""
    from scipy.interpolate import CubicSpline
    raw = np.fromfile(path, np.float64)
    raw = raw.reshape(-1, 4 if raw.size % 4 == 0 else 2)
    return CubicSpline(raw[:, 0], raw[:, 1])(radii)


def _read_condition(condition: str, path: str, geom: Geometry):
    """The 1d / 2d file of a Sigma/EnergyCondition; None for the profile."""
    if condition == "1d" and path:
        return np.broadcast_to(read_1d_profile(path, geom.rmed)[:, None],
                               (geom.nrad, geom.naz)).copy()
    if condition == "2d" and path:
        return np.fromfile(path, np.float64).reshape(geom.nrad, geom.naz)
    return None


def _com_distance(geom: Geometry, com_x: float, com_y: float,
                  radial: np.ndarray) -> np.ndarray:
    """Distance from the bodies' centre of mass of each (row radius, cell
    centre azimuth) position; ``radial`` holds one radius a row."""
    phi = geom.phi[None, :]
    x = radial[:, None] * np.cos(phi) - com_x
    y = radial[:, None] * np.sin(phi) - com_y
    return np.hypot(x, y)


def nbody_centered_sigma(phys: Physics, geom: Geometry, com_x: float,
                         com_y: float) -> np.ndarray:
    """The Sigma power law at the distance from the centre of mass
    (reference src/init.cpp:962-997): the profile samples the cell's inner
    interface radius Rinf times CenterProfileDensityCorrectionFactor, the
    profile cutoffs (:1063-1147) the cell centre's distance, the floor
    after each."""
    r_inf = _com_distance(geom, com_x, com_y, geom.rinf)
    floor = phys.sigma_floor * phys.sigma0
    sigma = np.maximum(
        phys.sigma0 * r_inf ** (-phys.sigma_slope)
        * phys.center_mass_density_correction_factor, floor)
    r_med = _com_distance(geom, com_x, com_y, geom.rmed)
    if phys.profile_cutoff_outer:
        sigma = np.maximum(sigma * dm.cutoff_outer(
            phys.profile_cutoff_point_outer,
            phys.profile_cutoff_width_outer, r_med), floor)
    if phys.profile_cutoff_inner:
        sigma = np.maximum(sigma * dm.cutoff_inner(
            phys.profile_cutoff_point_inner,
            phys.profile_cutoff_width_inner, r_med), floor)
    return sigma


def nbody_centered_energy(phys: Physics, constants: Constants,
                          geom: Geometry, com_x: float, com_y: float,
                          com_mass: float, sigma: np.ndarray) -> np.ndarray:
    """The energy profile of the bodies' total mass at the cell centre's
    distance from their centre of mass (reference src/init.cpp:1302-1348),
    floored at the temperature floor of ``sigma``, then damped by the
    cutoffs with the floor after each (:1363-1457)."""
    r_med = _com_distance(geom, com_x, com_y, geom.rmed)
    energy = dm.initial_energy(phys, constants, r_med, com_mass)
    e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
        / (phys.adiabatic_index - 1.0)
    energy = np.maximum(energy, e_floor)
    if phys.profile_cutoff_outer:
        energy = np.maximum(energy * dm.cutoff_outer(
            phys.profile_cutoff_point_outer,
            phys.profile_cutoff_width_outer, r_med), e_floor)
    if phys.profile_cutoff_inner:
        energy = np.maximum(energy * dm.cutoff_inner(
            phys.profile_cutoff_point_inner,
            phys.profile_cutoff_width_inner, r_med), e_floor)
    return energy


def nbody_centered_velocities(phys: Physics, constants: Constants,
                              geom: Geometry, com: tuple, v_com: tuple,
                              com_mass: float, quad_moment: float,
                              dist_secondary: float):
    """Velocities around the bodies' centre of mass (reference
    src/init.cpp:1467-1608, the N-body-centred branch): each cell takes
    the rotation and drift of the total mass at its distance from the
    centre of mass, as a Cartesian vector in that frame, plus the centre
    of mass's velocity, projected on the grid's polar axes. The
    quadrupole-supported v_az holds only beyond twice the secondary's
    distance (:1514-1520). Returns (vrad, vaz)."""
    G = constants.G

    def model(radial_rows: np.ndarray, phi_row: np.ndarray):
        x = radial_rows[:, None] * np.cos(phi_row)[None, :] - com[0]
        y = radial_rows[:, None] * np.sin(phi_row)[None, :] - com[1]
        r_com = np.hypot(x, y)
        if phys.initialize_pure_keplerian:
            vazi0 = np.sqrt(G * com_mass / r_com)
            vr0 = dm.viscous_radial_speed_analytic(phys, constants, r_com,
                                                   com_mass)
        else:
            vazi0 = dm.v_az_smoothed(phys, constants, r_com, com_mass)
            if quad_moment > 0.0 and phys.vaz_quadrupole_support:
                vazi0 = np.where(r_com > 2.0 * dist_secondary,
                                 dm.v_az_smoothed(phys, constants, r_com,
                                                  com_mass, quad_moment),
                                 vazi0)
            vr0 = dm.vr_numerical_viscous(phys, constants, r_com, com_mass)
        if phys.initialize_vradial_zero:
            vr0 = np.zeros_like(r_com)
        vx = (vr0 * x - vazi0 * y) / r_com + v_com[0]
        vy = (vr0 * y + vazi0 * x) / r_com + v_com[1]
        return vx, vy

    # v_rad at the interface radii (row NR repeats Rinf[NR-1], reference
    # :1492-1496) and the cell centre's azimuth
    phi_c = geom.phi
    ra = np.concatenate([geom.rinf, [geom.rinf[-1]]])
    vx, vy = model(ra, phi_c)
    vrad = vx * np.cos(phi_c)[None, :] + vy * np.sin(phi_c)[None, :]
    # v_az at the cell centre radii and the azimuthal interfaces
    phi_i = phi_c - 0.5 * geom.dphi
    vx, vy = model(geom.rmed, phi_i)
    vaz = (vy * np.cos(phi_i)[None, :] - vx * np.sin(phi_i)[None, :]
           - phys.omega_frame * geom.rmed[:, None])
    return vrad, vaz


def add_gaussian_rings(phys: Physics, constants: Constants, geom: Geometry,
                       sigma: np.ndarray, energy: np.ndarray,
                       com=None, com_mass=None):
    """The circumbinary ring (reference src/init.cpp:889-958 +
    :1208-1256): an asymmetric Gaussian enhancement of Sigma and, with an
    energy equation, of the energy, of independent inner width and outer
    decay width and exponent, centred on ``com`` where given. Returns
    (sigma, energy)."""
    if com is not None:
        x, y = geom.cell_centers_xy()
        r = np.hypot(x - com[0], y - com[1])
        mass = com_mass
    else:
        r = np.broadcast_to(geom.rmed[:, None], sigma.shape)
        mass = phys.hydro_center_mass
    r_ring = phys.cbd_ring_position
    fac = phys.cbd_ring_enhancement_factor
    w_in = phys.cbd_ring_width
    w_out = phys.cbd_decay_width
    p_out = phys.cbd_decay_exponent
    bump = np.where(
        r < r_ring,
        np.exp(-((r_ring - r) ** 2) / (2.0 * w_in ** 2)),
        np.exp(-(np.maximum(r - r_ring, 0.0) ** p_out)
               / (2.0 * w_out ** 2)))
    sigma = sigma + phys.sigma0 * r ** (-phys.sigma_slope) * (fac - 1.0) \
        * bump
    if phys.is_adiabatic:
        energy = energy + dm.initial_energy(phys, constants, r, mass) \
            * (fac - 1.0) * bump
    return sigma, energy


def apply_secondary_disk(phys: Physics, constants: Constants,
                         geom: Geometry, sigma, energy, vrad, vaz,
                         nbody: dict):
    """SecondaryDisk: a disk around body 1 inside its Roche lobe (reference
    src/init.cpp:624-888 ``init_secondary_disk_*``): the power law scaled
    by sqrt(m_1) with the outer cutoff at the Roche radius, where it
    exceeds the gas already there, and its velocities about the secondary
    minus the secondary's own (the reference's sign, :819-821). Returns
    (sigma, energy, vrad, vaz)."""
    px, py = float(nbody["x"][1]), float(nbody["y"][1])
    pvx, pvy = float(nbody["vx"][1]), float(nbody["vy"][1])
    pm = float(nbody["mass"][1])
    q = pm / float(nbody["mass"][0])
    # Eggleton 1983 (reference src/Theo.cpp:306-312)
    rl = 0.49 * q ** (2.0 / 3.0) / (0.6 * q ** (2.0 / 3.0)
                                    + np.log(1.0 + q ** (1.0 / 3.0)))
    compute_radius = rl * np.hypot(px, py)
    disk_size = phys.profile_cutoff_point_outer * rl / (1.0 - rl)
    cutoff_width = phys.profile_cutoff_width_outer * rl / (1.0 - rl)
    scaling = np.sqrt(pm)
    min_dist = geom.rmin / 3.0

    x, y = geom.cell_centers_xy()
    r_sec = np.maximum(np.hypot(x - px, y - py), min_dist)
    inside = r_sec < compute_radius
    cut = dm.cutoff_outer(disk_size, cutoff_width, r_sec)
    dens = phys.sigma0 * scaling * r_sec ** (-phys.sigma_slope) * cut
    old = np.maximum(sigma, phys.sigma_floor * phys.sigma0)
    sigma = np.where(inside, np.maximum(dens, old), sigma)
    if phys.is_adiabatic:
        e_sec = dm.initial_energy(phys, constants, r_sec, pm) * scaling * cut
        e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
            / (phys.adiabatic_index - 1.0)
        energy = np.where(inside, np.maximum(e_sec, e_floor), energy)

    def model_v(r_pos, phi):
        xs = r_pos * np.cos(phi) - px
        ys = r_pos * np.sin(phi) - py
        rs = np.maximum(np.hypot(xs, ys), min_dist)
        if phys.initialize_pure_keplerian:
            vazi0 = np.sqrt(constants.G * pm / rs)
            vr0 = dm.viscous_radial_speed_analytic(phys, constants, rs, pm) \
                * np.ones_like(rs)
        else:
            vazi0 = dm.v_az_smoothed(phys, constants, rs, pm)
            vr0 = dm.vr_numerical_viscous(phys, constants, rs, pm)
        if phys.initialize_vradial_zero:
            vr0 = np.zeros_like(rs)
        vx = (vr0 * xs - vazi0 * ys) / rs
        vy = (vr0 * ys + vazi0 * xs) / rs
        return rs, vx - pvx, vy - pvy

    phi_c = geom.phi
    # v_rad at the radial faces, at the cells' azimuths
    ra = np.concatenate([geom.rinf, [geom.rinf[-1]]])
    rs, vx, vy = model_v(ra[:, None], phi_c[None, :])
    vr_model = (ra[:, None] * np.cos(phi_c)[None, :] * vx
                + ra[:, None] * np.sin(phi_c)[None, :] * vy) / ra[:, None]
    vrad = np.where(rs < compute_radius, vr_model, vrad)
    # v_az at the azimuthal interfaces
    phi_i = phi_c - 0.5 * geom.dphi
    rs, vx, vy = model_v(geom.rmed[:, None], phi_i[None, :])
    va_model = np.cos(phi_i)[None, :] * vy - np.sin(phi_i)[None, :] * vx
    vaz = np.where(rs < compute_radius, va_model, vaz)
    return sigma, energy, vrad, vaz


def _construct_sequence(u0: float, v: np.ndarray) -> tuple[np.ndarray, float]:
    """u with u[0] = u0 and (u[i] + u[i-1]) / 2 = v[i], and the sum of
    |u''| (reference src/Pframeforce.cpp:295-306 ``ConstructSequence``)."""
    u = np.empty(v.size)
    u[0] = u0
    for i in range(1, v.size):
        u[i] = 2.0 * v[i] - u[i - 1]
    return u, np.abs(u[2:] + u[:-2] - 2.0 * u[1:-1]).sum()


def centrifugal_balance_vaz(phys: Physics, constants: Constants,
                            geom: Geometry, sigma: np.ndarray,
                            energy: np.ndarray) -> np.ndarray:
    """CentrifugalBalance: v_az(r) in balance with gravity and the
    azimuthally averaged pressure gradient at the interfaces, then the
    cell-centred sequence whose interface means they are, found by two
    shots and a secant (reference src/init.cpp:1638-1717); ring 0 the
    Keplerian extrapolation (:1748-1755)."""
    nr = geom.nrad
    sig1d = sigma.mean(axis=1)
    rmed = geom.rmed
    gm = constants.G * phys.hydro_center_mass
    if phys.is_adiabatic:
        press1d = (phys.adiabatic_index - 1.0) * energy.mean(axis=1)
    else:
        cs = phys.aspectratio_ref * rmed ** phys.flaring_index \
            * np.sqrt(gm / rmed)
        press1d = sig1d * cs ** 2
    radii = geom.rinf
    vt_int = np.zeros(nr)
    vt_int[1:] = (press1d[1:] - press1d[:-1]) \
        / (0.5 * (sig1d[1:] + sig1d[:-1])) / (rmed[1:] - rmed[:-1]) \
        + gm * (1.0 / rmed[:-1] - 1.0 / rmed[1:]) / (rmed[1:] - rmed[:-1])
    vt_int[1:] = np.sqrt(vt_int[1:] * radii[1:]) \
        - radii[1:] * phys.omega_frame
    t1 = vt_int[1] + 0.75 * (vt_int[1] - vt_int[2])
    _, r1 = _construct_sequence(t1, vt_int)
    t2 = t1 + 0.25 * (vt_int[1] - vt_int[2])
    _, r2 = _construct_sequence(t2, vt_int)
    t1 = t1 - r1 / (r2 - r1) * (t2 - t1)
    vt_cent, _ = _construct_sequence(t1, vt_int)
    vk0 = rmed[0] * np.sqrt(gm / rmed[0] ** 3)
    vk1 = rmed[1] * np.sqrt(gm / rmed[1] ** 3)
    vt_cent[0] = vt_cent[1] * vk0 / vk1
    return np.broadcast_to(vt_cent[:, None], (nr, geom.naz)).copy()


def build_initial_state(phys: Physics, constants: Constants, geom: Geometry,
                        quad_moment: float = 0.0, nbody: dict | None = None,
                        *, dtype: torch.dtype, device: torch.device | str
                        ) -> tuple[FieldState, Physics]:
    """The initial fields (reference src/init.cpp:255-341 ``init_physics``)
    and the Physics, whose sigma0 ``SetSigma0`` renormalises.
    ``quad_moment`` is the binary quadrupole moment of the v_az support;
    ``nbody`` (the bodies' x, y, vx, vy and mass, float64 arrays) centres
    the ``nbody`` conditions and the circumbinary ring on the bodies'
    centre of mass. The order is the JAX package's
    (fargocpt_tpu/initial.py:544-642)."""
    com, com_mass = None, phys.hydro_center_mass
    if nbody is not None:
        m = np.asarray(nbody["mass"])
        com_mass = float(m.sum())
        com = (float((m * np.asarray(nbody["x"])).sum() / m.sum()),
               float((m * np.asarray(nbody["y"])).sum() / m.sum()))
    nbody_centred = phys.sigma_condition == "nbody" and com is not None
    if phys.shock_tube in (1, 2):
        # the velocities take the standard path (src/init.cpp:330-331 runs
        # init_gas_velocities unconditionally), nothing else
        sigma, energy = shock_tube_fields(geom, pvte=phys.shock_tube == 2)
        vrad, vaz = gas_velocities(phys, constants, geom, quad_moment)
        return _to_state(sigma, vrad, vaz, energy, dtype, device), phys
    if phys.spreading_ring:
        sigma = spreading_ring_sigma(phys, geom)
        energy = np.zeros_like(sigma)
    else:
        sigma = _read_condition(phys.sigma_condition, phys.sigma_filename,
                                geom)
        if sigma is None:
            sigma = nbody_centered_sigma(phys, geom, *com) \
                if nbody_centred else powerlaw_sigma(phys, geom)
        if not phys.is_adiabatic:
            energy = np.zeros_like(sigma)
        else:
            energy = _read_condition(phys.energy_condition,
                                     phys.energy_filename, geom)
            if energy is None and phys.energy_condition == "nbody" \
                    and com is not None:
                energy = nbody_centered_energy(phys, constants, geom, *com,
                                               com_mass, sigma)
            elif energy is None:
                energy = powerlaw_energy(phys, constants, geom, sigma)
    if phys.sigma_randomize:
        sigma = randomize_sigma(phys, geom, sigma)
    if phys.sigma_adjust:
        sigma, energy, sigma0 = renormalize_sigma(phys, geom, sigma, energy)
        phys = phys.with_(sigma0=sigma0)
    if phys.cbd_ring:
        sigma, energy = add_gaussian_rings(
            phys, constants, geom, sigma, energy,
            com if phys.sigma_condition == "nbody" else None, com_mass)
    if nbody_centred:
        # the reference's N-body-centred branch returns early, before the
        # centrifugal balance (src/init.cpp:1473-1609)
        m = np.asarray(nbody["mass"])
        v_com = (float((m * np.asarray(nbody["vx"])).sum() / m.sum()),
                 float((m * np.asarray(nbody["vy"])).sum() / m.sum()))
        dist_sec = float(np.hypot(nbody["x"][1] - nbody["x"][0],
                                  nbody["y"][1] - nbody["y"][0])) \
            if m.size > 1 else 0.0
        vrad, vaz = nbody_centered_velocities(phys, constants, geom, com,
                                              v_com, com_mass, quad_moment,
                                              dist_sec)
    else:
        vrad, vaz = gas_velocities(phys, constants, geom, quad_moment)
        if phys.centrifugal_balance:
            vaz = centrifugal_balance_vaz(phys, constants, geom, sigma,
                                          energy)
    if phys.secondary_disk and nbody is not None:
        sigma, energy, vrad, vaz = apply_secondary_disk(
            phys, constants, geom, sigma, energy, vrad, vaz, nbody)
    return _to_state(sigma, vrad, vaz, energy, dtype, device), phys


def _to_state(sigma, vrad, vaz, energy, dtype, device) -> FieldState:
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FieldState(sigma=t(sigma), vrad=t(vrad), vaz=t(vaz),
                      energy=t(energy))

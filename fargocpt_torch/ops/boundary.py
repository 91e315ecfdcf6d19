"""Radial boundary conditions, the per-variable, per-edge menu
(reference src/boundary_conditions/boundary_conditions.cpp:65-110 with the
dispatch of src/boundary_conditions/config.cpp; the JAX package's
``fargocpt_tpu/ops/boundary.py:37-253``):

* the scalars (sigma, energy): zerogradient, outflow, reflecting,
  reference, diskmodel and none;
* v_rad: zerogradient, outflow, reflecting, reference, keplerian, viscous
  and none;
* v_az: keplerian, zerogradient, reference, zeroshear, balanced and none;
* the composite ``centerofmass`` (``center_of_mass_boundary``): the disk
  model around the bodies' centre of mass, evaluated on the device from
  the bodies' tensors;
* the Roche-lobe overflow stream (``rochelobe_overflow``): a Gaussian
  stream injected at the outer ghost ring around the donor's azimuth,
  evaluated on the device from the bodies' tensors.

The composite ``custom`` is the user's ``custom_boundary`` function
(``CustomBoundaryModule``), which ``HydroStep`` applies after this menu.

Ghost rows: row 0 / NR-1 of the scalar fields, rows 0,1 / NR-1,NR of
v_rad (row 1 / NR-1 sit on the active boundary). Each field is rebuilt by
one ``torch.cat`` of its ghost rows and its interior; every function
returns new tensors and leaves its inputs untouched. The ghost values that
depend on the grid alone are Python floats from the host's radii, so a BC
reads nothing back from the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import telemetry
from ..params import Physics
from . import diskmodel as dm
from .common import Geom

SCALAR_BCS = ("zerogradient", "outflow", "reflecting", "reference",
              "diskmodel", "none")
VRAD_BCS = ("zerogradient", "outflow", "reflecting", "reference",
            "keplerian", "viscous", "none")
VAZ_BCS = ("keplerian", "zerogradient", "reference", "zeroshear",
           "balanced", "none")
SUPPORTED = {"sigma": SCALAR_BCS, "energy": SCALAR_BCS, "vrad": VRAD_BCS,
             "vaz": VAZ_BCS}


@dataclass(frozen=True)
class RefValues:
    """Initial-value snapshots (reference SIGMA0/ENERGY0/... grids), the
    targets of the reference BCs and of the damping zones."""
    sigma0: torch.Tensor
    energy0: torch.Tensor
    vrad0: torch.Tensor
    vaz0: torch.Tensor


def check_supported(phys: Physics) -> None:
    """Raise NotImplementedError for a boundary name outside the menu,
    naming it: the JAX package's boundaries raise for the same names
    (fargocpt_tpu/ops/boundary.py), so this refuses them up front."""
    names = {"sigma": (phys.bc_sigma_inner, phys.bc_sigma_outer),
             "energy": (phys.bc_energy_inner, phys.bc_energy_outer),
             "vrad": (phys.bc_vrad_inner, phys.bc_vrad_outer),
             "vaz": (phys.bc_vaz_inner, phys.bc_vaz_outer)}
    for var, pair in names.items():
        for edge, name in zip(("inner", "outer"), pair):
            if name not in SUPPORTED[var]:
                raise NotImplementedError(
                    f"{edge} {var} boundary {name!r} is not in the menu")


def _row(x, value):
    """One (1, NAZ) row of ``x``'s type holding ``value``: a float or a
    0-d tensor (then a broadcast view, no launch)."""
    if torch.is_tensor(value):
        return value.to(x.dtype).reshape(1, 1).expand(1, x.shape[1])
    return torch.full((1, x.shape[1]), value, dtype=x.dtype,
                      device=x.device)


def _host(g: Geom, name: str, row: int) -> float:
    return float(g.host[name][row])


# ----- scalar BCs ------------------------------------------------------------

def _diskmodel_value(phys: Physics, var: str, r: float) -> float:
    """Analytic-profile ghost values (reference
    src/boundary_conditions/diskmodel.cpp:18-31 calc_sig/calc_eng, which
    omit the G*M factor of the initial energy)."""
    if var == "sigma":
        return phys.sigma0 * r ** (-phys.sigma_slope)
    return (1.0 / (phys.adiabatic_index - 1.0) * phys.sigma0
            * phys.aspectratio_ref ** 2
            * r ** (-phys.sigma_slope - 1.0 + 2.0 * phys.flaring_index))


def _scalar_ghost(name: str, x, x0, g: Geom, phys: Physics, var: str,
                  outer: bool):
    row = x.shape[0] - 1 if outer else 0
    inside = row - 1 if outer else 1
    if name in ("zerogradient", "outflow", "reflecting"):
        return x[inside:inside + 1]
    if name == "reference":
        return x0[row:row + 1]
    if name == "diskmodel":
        return _row(x, _diskmodel_value(phys, var, _host(g, "rmed", row)))
    if name == "none":
        return x[row:row + 1]
    raise NotImplementedError(f"scalar {'outer' if outer else 'inner'} BC "
                              f"{name!r}")


def _scalar(names, x, x0, g: Geom, phys: Physics, var: str):
    nr = x.shape[0]
    return torch.cat([_scalar_ghost(names[0], x, x0, g, phys, var, False),
                      x[1:nr - 1],
                      _scalar_ghost(names[1], x, x0, g, phys, var, True)],
                     dim=0)


# ----- v_rad BCs -------------------------------------------------------------

def _vrad_ghosts(name: str, vr, vr0, g: Geom, phys: Physics, gm: float,
                 nu, outer: bool):
    """The two ghost faces of one edge, in row order: faces 0, 1 (inner;
    face 1 on the boundary) or NR-1, NR (outer; face NR-1 on it)."""
    nv = vr.shape[0]                   # NR + 1
    irad = nv - 1
    # the edge face, the face beyond it, the interior face they copy
    edge, ghost, src = (irad - 1, irad, irad - 2) if outer else (1, 0, 2)
    if name == "zerogradient":
        rows = (vr[src:src + 1],) * 2
    elif name == "outflow":
        # reference src/boundary_conditions/outflow.cpp:16-35
        v = vr[src:src + 1]
        v = torch.clamp(v, min=0.0) if outer else torch.clamp(v, max=0.0)
        rows = (v, v)
    elif name == "reflecting":
        rows = {ghost: -vr[src:src + 1], edge: torch.zeros_like(vr[:1])}
        rows = (rows[min(edge, ghost)], rows[max(edge, ghost)])
    elif name == "reference":
        lo = irad - 1 if outer else 0
        rows = (vr0[lo:lo + 2],)
    elif name == "keplerian":
        # reference src/boundary_conditions/keplerian_radial.cpp:18-63
        factor = phys.keplerian_radial_outer_factor if outer \
            else phys.keplerian_radial_inner_factor
        lo = irad - 1 if outer else 0
        rows = tuple(_row(vr, factor * math.sqrt(
            gm / _host(g, "rmed_ext", lo + k))) for k in range(2))
    elif name == "viscous":
        # the steady viscous drift at the edge (reference
        # src/boundary_conditions/viscous.cpp:12-48)
        if nu is None:
            raise ValueError("the viscous BC needs the viscosity grid")
        nu_edge = 0.5 * (nu[-1:] + nu[-2:-1]) if outer \
            else 0.5 * (nu[0:1] + nu[1:2])
        lo = irad - 1 if outer else 0
        vos = phys.viscous_outflow_speed
        rows = tuple(-1.5 * vos / _host(g, "ra", lo + k) * nu_edge
                     for k in range(2))
    elif name == "none":
        lo = irad - 1 if outer else 0
        rows = (vr[lo:lo + 2],)
    else:
        raise NotImplementedError(f"vrad {'outer' if outer else 'inner'} "
                                  f"BC {name!r}")
    return list(rows)


def _vrad(vr, vr0, g: Geom, phys: Physics, gm: float, nu):
    nv = vr.shape[0]
    inner = _vrad_ghosts(phys.bc_vrad_inner, vr, vr0, g, phys, gm, nu, False)
    outer = _vrad_ghosts(phys.bc_vrad_outer, vr, vr0, g, phys, gm, nu, True)
    return torch.cat([*inner, vr[2:nv - 2], *outer], dim=0)


# ----- v_az BCs --------------------------------------------------------------

def _balanced_value(phys: Physics, constants, r: float, omega_frame):
    """Pressure-gradient / smoothing-balanced equilibrium v_az at a ghost
    ring (reference src/boundary_conditions/balanced.cpp:23-75, Baruteau
    2008)."""
    vk2 = constants.G * phys.hydro_center_mass / r
    support = 0.0
    if not phys.profile_cutoff_outer:
        h = phys.aspectratio_ref * r ** phys.flaring_index
        support = support + (2.0 * phys.flaring_index - 1.0
                             - phys.sigma_slope) * h ** 2
        he2 = (h * phys.thickness_smoothing) ** 2
        support = support + (1.0 + (phys.flaring_index + 1.0) * he2) \
            / math.sqrt(1.0 + he2) ** 3
    return math.sqrt(vk2 * support) - r * omega_frame


def _vaz_ghost(phys: Physics, constants, name: str, vaz, vaz0, g: Geom,
               omega_frame, outer: bool):
    nr = vaz.shape[0]
    row, inside = (nr - 1, nr - 2) if outer else (0, 1)
    if name == "keplerian":
        # reference src/boundary_conditions/keplerian_azimuthal.cpp:19-38
        factor = phys.keplerian_azimuthal_outer_factor if outer \
            else phys.keplerian_azimuthal_inner_factor
        r = _host(g, "rmed", row)
        vkep = math.sqrt(constants.G * phys.hydro_center_mass / r)
        return _row(vaz, factor * vkep - r * omega_frame.to(vaz.dtype))
    if name == "zerogradient":
        return vaz[inside:inside + 1]
    if name == "reference":
        return vaz0[row:row + 1]
    if name == "zeroshear":
        # d(omega)/dr = 0
        return vaz[inside:inside + 1] * _host(g, "rmed", row) \
            / _host(g, "rmed", inside)
    if name == "balanced":
        return _row(vaz, _balanced_value(phys, constants,
                                         _host(g, "rmed", row),
                                         omega_frame.to(vaz.dtype)))
    if name == "none":
        return vaz[row:row + 1]
    raise NotImplementedError(f"vaz {'outer' if outer else 'inner'} BC "
                              f"{name!r}")


def apply_boundary_conditions(phys: Physics, constants, g: Geom,
                              sigma, vrad, vaz, energy, ref: RefValues,
                              omega_frame: torch.Tensor, nu=None,
                              rof_ctx=None, com_ctx=None):
    """Per-variable x per-edge dispatch (reference
    src/boundary_conditions/boundary_conditions.cpp:65-110). ``nu`` is the
    viscosity grid the viscous v_rad BC reads; ``rof_ctx`` = (bodies, time,
    temperature unit, hours per time unit, length unit in cm, mdot) of the
    Roche-lobe overflow stream, which then overwrites the outer ghosts in
    its window; ``com_ctx`` = (bodies, n_hydroframe, quadrupole moment) for
    a ``centerofmass`` side, which then overwrites that side's ghosts (the
    JAX package's order). Damping is a separate call (``ops/damping.py``)
    made on the final BC application of a step."""
    sigma = _scalar((phys.bc_sigma_inner, phys.bc_sigma_outer), sigma,
                    ref.sigma0, g, phys, "sigma")
    energy = _scalar((phys.bc_energy_inner, phys.bc_energy_outer), energy,
                     ref.energy0, g, phys, "energy")
    gm = constants.G * phys.hydro_center_mass
    vrad = _vrad(vrad, ref.vrad0, g, phys, gm, nu)
    nr = vaz.shape[0]
    vaz = torch.cat([
        _vaz_ghost(phys, constants, phys.bc_vaz_inner, vaz, ref.vaz0, g,
                   omega_frame, False),
        vaz[1:nr - 1],
        _vaz_ghost(phys, constants, phys.bc_vaz_outer, vaz, ref.vaz0, g,
                   omega_frame, True)], dim=0)
    if phys.rochelobe_overflow and rof_ctx is not None:
        sigma, vrad, vaz, energy = rochelobe_overflow(
            phys, constants, g, sigma, vrad, vaz, energy, omega_frame,
            *rof_ctx)
    if com_ctx is not None:
        nb, n_hydroframe, quad = com_ctx
        for outer, comp in ((False, phys.composite_inner),
                            (True, phys.composite_outer)):
            if comp == "centerofmass":
                sigma, vrad, vaz, energy = center_of_mass_boundary(
                    phys, constants, g, sigma, vrad, vaz, energy, nb,
                    n_hydroframe, quad, omega_frame, outer=outer)
    return sigma, vrad, vaz, energy


def _put_row(x, row: int, value):
    """``x`` with row ``row`` replaced by ``value`` (NAZ,)."""
    return torch.cat([x[:row], value.to(x.dtype)[None, :], x[row + 1:]],
                     dim=0)


@telemetry.spanned("boundary.center_of_mass")
def center_of_mass_boundary(phys: Physics, constants, g: Geom, sigma, vrad,
                            vaz, energy, nb, n_hydroframe: int,
                            quad_moment: float, omega_frame,
                            outer: bool = True):
    """The circumbinary ghost ring: the disk model around the bodies' centre
    of mass, shifted back to the grid's frame (reference
    src/boundary_conditions/center_of_mass.cpp:37-425
    ``diskmodel_center_of_mass_boundary_{outer,inner}``;
    fargocpt_tpu/ops/boundary.py:254-332).

    The two sides differ (center_of_mass.cpp:44-47 against :231-236): the
    outer side takes the centre of mass of all bodies, the
    quadrupole-supported v_az and the grid-corrected drift; the inner side
    the first ``n_hydroframe`` bodies, the plain smoothed v_az and the
    uncorrected drift. The centre of mass comes from the float64 body
    tensors ``nb``, on the device; the model is evaluated in the field
    type, the azimuths' cosines and sines in float64 as the JAX package
    takes them."""
    n_com = None if outer else n_hydroframe
    m = nb.mass[:n_com]
    com_m = torch.sum(m)
    com_x = torch.sum(m * nb.x[:n_com]) / com_m
    com_y = torch.sum(m * nb.y[:n_com]) / com_m
    com_vx = torch.sum(m * nb.vx[:n_com]) / com_m
    com_vy = torch.sum(m * nb.vy[:n_com]) / com_m

    dtype = sigma.dtype
    nr = g.nrad
    row = nr - 1 if outer else 0
    phi_c = torch.arange(g.naz, dtype=torch.float64,
                         device=sigma.device) * g.dphi

    def cos_sin(phi):
        return torch.cos(phi).to(dtype), torch.sin(phi).to(dtype)

    def profile_velocities(r_pos, cos_p, sin_p):
        """(x, y, vx, vy) of the model flow at radii ``r_pos`` and the
        azimuths of (cos_p, sin_p), from the profile around the centre of
        mass."""
        x = r_pos * cos_p
        y = r_pos * sin_p
        x_com = x - com_x
        y_com = y - com_y
        r_com = torch.sqrt(x_com ** 2 + y_com ** 2)
        if phys.initialize_pure_keplerian:
            vazi0 = dm.v_kepler(constants, r_com, com_m)
            vr0 = dm.viscous_radial_speed_analytic(phys, constants, r_com,
                                                   com_m)
        else:
            # the quadrupole-supported v_az on the outer side only
            # (center_of_mass.cpp:79-85 against :42); the drift model's
            # rotation keeps the quadrupole on both sides
            # (viscous_radial_speed.cpp:141-147)
            vazi0 = dm.v_az_smoothed(phys, constants, r_com, com_m,
                                     quad_moment if outer else 0.0)
            vr0 = dm.vr_numerical_viscous(phys, constants, r_com, com_m,
                                          quad_moment)
            if outer:
                vr0 = vr0 * dm.vr_outer_grid_correction(
                    phys, constants, g, r_com, com_m, quad_moment)
        vx = (vr0 * x_com - vazi0 * y_com) / r_com + com_vx
        vy = (vr0 * y_com + vazi0 * x_com) / r_com + com_vy
        return x, y, vx, vy

    # one evaluation of three rows: v_az at the ghost ring's radius and the
    # azimuthal interfaces (phi - dphi / 2), v_rad at the two radial faces
    # bounding the ghost ring and the cell centres' azimuths
    faces = (row, row + 1) if outer else (1, 0)
    cos_i, sin_i = cos_sin(phi_c - 0.5 * g.dphi)
    cos_c, sin_c = cos_sin(phi_c)
    r_rows = torch.stack([g.rb[row], g.ra[faces[0]], g.ra[faces[1]]])
    x, y, vx, vy = profile_velocities(
        r_rows, torch.stack([cos_i, cos_c, cos_c]),
        torch.stack([sin_i, sin_c, sin_c]))
    r_row = g.rb[row, 0]
    vaz = _put_row(vaz, row, (x[0] * vy[0] - vx[0] * y[0]) / r_row
                   - omega_frame.to(dtype) * r_row)
    for k, f in enumerate(faces, start=1):
        vrad = _put_row(vrad, f, (x[k] * vx[k] + y[k] * vy[k]) / g.ra[f, 0])
    # Sigma and the energy of the profile around the centre of mass, the
    # energy above the temperature floor (reference :196-225)
    r_com = torch.sqrt((r_row * cos_c - com_x) ** 2
                       + (r_row * sin_c - com_y) ** 2)
    sig_row = phys.sigma0 * r_com ** (-phys.sigma_slope)
    sigma = _put_row(sigma, row, sig_row)
    if phys.is_adiabatic:
        e_floor = phys.minimum_temperature * sig_row / phys.mu \
            * constants.R / (phys.adiabatic_index - 1.0)
        energy = _put_row(energy, row, torch.maximum(
            dm.initial_energy(phys, constants, r_com, com_m), e_floor))
    return sigma, vrad, vaz, energy


@telemetry.spanned("boundary.rochelobe")
def rochelobe_overflow(phys: Physics, constants, g: Geom, sigma, vrad, vaz,
                       energy, omega_frame, nb, current_time,
                       temp0_factor: float, time_to_hours: float,
                       length_to_cm: float, mdot=None):
    """The Roche-lobe overflow stream injected at the outer ghost ring
    around the donor's azimuth (reference
    src/boundary_conditions/mass_overflow.cpp:22-140;
    fargocpt_tpu/ops/boundary.py:335-398): a Gaussian stream whose width
    follows the donor's temperature and orbital period, ramped in as sin^6
    over ``ROFrampingtime`` donor orbits. Sigma, the energy (adiabatic) and
    v_az go on ring NR-1, v_rad on faces NR-1 and NR; v_az covers the
    window and the cells after it.

    The donor's orbit, its nearest cell and the stream's profile are
    float64 tensors on the device, from the float64 bodies ``nb`` (the JAX
    package forms them in the field type); ``current_time`` and ``mdot``
    (None: ``ROFvalue``) are floats or 0-d tensors, a float staying a
    Python number: nothing is copied to the device or read back."""
    dev, dtype = sigma.device, sigma.dtype
    f64 = lambda v: v.to(torch.float64) \
        if torch.is_tensor(v) else v  # noqa: E731
    k = phys.rof_planet
    x, y, vx, vy = nb.x[k], nb.y[k], nb.vx[k], nb.vy[k]
    omega_frame = f64(omega_frame)
    r2 = x * x + y * y
    omega_planet = (x * vy - y * vx) / r2 + omega_frame
    angle = torch.atan2(y, x) / (2.0 * math.pi)
    angle = torch.where(angle < 0.0, angle + 1.0, angle)

    nr, naz = g.nrad, g.naz
    r_cell = _host(g, "rmed", nr - 1)
    vr_fraction = 0.002
    vr_stream = -omega_planet * r_cell * vr_fraction
    vazi_stream = (omega_planet - omega_frame) * r_cell
    if mdot is None:
        mdot = phys.rof_mdot
    sigma_stream = torch.abs(f64(mdot) / (g.dphi * _host(g, "ra", nr - 1)
                                          * vr_stream))

    # the nearest cell; naz * angle + 0.5 > 0, so the cast is a floor
    nearest = torch.remainder((naz * angle + 0.5).to(torch.int64), naz)
    porb_hours = 2.0 * math.pi / omega_planet * time_to_hours
    q_w = 2.4e13 * (phys.rof_temperature * temp0_factor) * porb_hours ** 2
    w = torch.sqrt(q_w / math.pi)
    circ = 2.0 * math.pi * r_cell * length_to_cm
    sig_frac = 2.0 * w / circ
    sigmabar = naz * sig_frac

    t = f64(current_time)
    period = 2.0 * math.pi / omega_planet
    t_ramp = phys.rof_rampingtime * period
    ramp = torch.where(t < t_ramp,
                       torch.sin(t * (math.pi / 2.0)
                                 / torch.clamp(t_ramp, min=1e-300)) ** 6,
                       torch.ones_like(t_ramp))

    j = torch.arange(naz, device=dev)
    # the signed azimuthal offset to the stream's centre, across the seam
    di = torch.remainder(j - nearest + naz // 2, naz) - naz // 2
    window = torch.abs(di) <= torch.clamp(3.0 * sigmabar, min=0.0)
    sbar = torch.clamp(sigmabar, min=1e-30)
    weight = torch.where(
        sigmabar > 0.0,
        torch.exp(-0.5 * (di / sbar) ** 2) / (sbar * math.sqrt(2.0 * math.pi)),
        (di == 0).to(torch.float64))
    dens = torch.clamp(ramp * weight * sigma_stream,
                       min=phys.sigma_floor * phys.sigma0)

    row = nr - 1
    sigma = _put_row(sigma, row, torch.where(window, dens.to(dtype),
                                             sigma[row]))
    if phys.is_adiabatic:
        e_stream = phys.rof_temperature * dens / phys.mu * constants.R \
            / (phys.adiabatic_index - 1.0)
        energy = _put_row(energy, row, torch.where(window, e_stream.to(dtype),
                                                   energy[row]))
    vr_row = vr_stream.to(dtype)
    vrad = torch.cat([vrad[:row],
                      torch.where(window, vr_row, vrad[row:row + 2])], dim=0)
    window_vaz = window | torch.roll(window, 1)
    vaz = _put_row(vaz, row, torch.where(window_vaz, vazi_stream.to(dtype),
                                         vaz[row]))
    return sigma, vrad, vaz, energy

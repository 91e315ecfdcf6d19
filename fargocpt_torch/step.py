"""The hydro step, Euler or leapfrog, and the CFL time step (reference
src/simulation.cpp:148-274 ``step_Euler``, :276-483 ``step_LeapFrog``,
src/cfl.cpp).

The gas substeps take the decomposition the JAX package picks from the
configuration (``fargocpt_tpu/step.py:244-304``, ``gates`` below, without
its TPU-only dtype and NAZ % 128 terms):

* constant gamma (the flagship): the fused ops, each a CUDA kernel on the
  GPU: the potential + momentum sources, then the viscous kick
  (compression heating, artificial viscosity, viscosity, SubStep3), and
  the CFL;
* variable gamma (PVTE, the PDS70 gas setup): the JAX package's unfused
  composition of PyTorch ops: sources with the PVTE grids, the
  Stone-Norman artificial viscosity (the ``artvisc_sn`` CUDA kernel on the
  GPU), the energy floor, viscosity, SubStep3 with surface cooling, and
  the CFL on the PVTE sound speed.

Both equations of state of a constant gamma take the fused ops: the ideal
gas and the locally isothermal disk (no energy equation: its energy grid
stays as it starts, zero, and only an adiabatic run clamps it to the
temperature range, as the JAX package gates it).

Self-gravity kicks the gas first; FLD radiative diffusion follows the
substeps. Then the boundary conditions and the FARGO transport, whose
route is fixed when the ``HydroStep`` is built (``ops/transport.route``,
or the ``transport_route`` the caller names); the damping zones
(``ops/damping.py``) act in the step's final boundary call only. The dust
swarm (``particles/dust.py``) is integrated against the step-start gas
fields, after the N-body kick and before the frame rotation.

Planets. The gas feels each body's ramped mass (``bodies_on_grid``), the
bodies feel the disk (``DiskFeedback``) and the frame's indirect terms,
and drift under their mutual gravity by IAS15 (the ``ias15`` kernel on the
GPU, twice an Euler step: the indirect term's predictor and the drift).
A body with a temperature irradiates the disk (``HeatingStar``, the
SubStep3 of the unfused substeps).

The leapfrog (``Integrator: LeapFrog``) kicks the gas twice a step by half
a step each, with the transport between the kicks, while the bodies drift
by two halves around them (four ``ias15`` calls: two drifts, two
predictors). What each kick reads is as stale as the reference leaves it:
kick 1's N-body indirect term comes from the bodies before the first
drift, its potential smoothing from the scale height of the step's start;
kick 2's potential and feedback smoothing from the scale height of kick
1's viscosity stage, ``h_kick1``, and each boundary call after a kick from
that kick's viscosity grid. With the fused viscous kick those two come
from the kernel's in-kick sound speed (``kernels.viscous_kick``
``want_cs``), which the step asks for only where an adiabatic run reads
them: a viscous v_rad boundary, viscous damping, the leapfrog.
Accretion onto the bodies (``ops/accretion.py``: Kley, sinkhole,
viscous) runs at an Euler step's start and before each leapfrog half's
kick to the bodies; the first kick of an accreting step reads the
pressure of the fields before it, so that kick takes the unfused sources
substep (``stale_derived``), and the leapfrog's second kick the kernel.
The corotating frame sets its rate from the reference body's
swept angle: against its position at the run's start in the Euler step,
over each half drift in the leapfrog; the rate stays a 0-d device tensor,
which the kernels read on the device. The monitor grids of the ``Write*``
flags (``state.MonitorAccum``) accumulate after each step on the device.
The ops dispatch on the tensors' device (``ops/kernels.py``): the plain
PyTorch versions on the CPU, the CUDA kernels on a GPU.

The circumbinary menu. Under AspectRatioMode 1 / 2 the sound speed and
scale height come from the bodies (``derived`` given the bodies), under
AlphaMode the viscosity takes a per-cell alpha (``viscosity_grid`` given
the fields), StabilizeViscosity 1 scales the viscous update and 2 limits
the CFL, and a ``centerofmass`` side builds its ghosts from the bodies
(``_apply_bcs`` given them). Which call site passes the bodies follows
the JAX package site for site, the kick-scoped staleness of H and nu
included; the output and the monitor grids take the mode-0 grids, as
there. The gates keep the fused sources, viscous kick and CFL off under
these modes.

The cataclysmic variables. With RocheLobeOverflow every boundary call
that has the bodies injects the donor's stream at the outer ghost ring
(``ops/boundary.rochelobe_overflow``, on the device); the Euler step
tracks the rate through the inner face (``MonitorAccum.rof_mdot``), which
ROFVariableTransfer feeds to its final boundary call (the leapfrog keeps
no tracker, as in the JAX package). KeepDiskMassConstant rescales sigma
after each step's final boundary call; a ``custom`` side runs the user's
``custom_bc`` after the named boundaries; SubStep3 takes S-curve cooling
and the Ziampras, model and floor beta variants (``ops/energy.py``), all
outside the fused viscous kick's gate.

The long tail. The polytropic disk takes the unfused substeps with its
own sound speed, pressure and temperature (``ops/eos.py``). Under
Bessel-kernel self-gravity (the default mode) ``derived`` scales H by the
disk's Toomre Q and the kernel stays as built. ``Disk: no`` keeps the dt
and runs no gas step: the bodies drift and the dust moves, FLD still runs
on the Euler step (reference src/simulation.cpp:205-208), and no boundary,
transport or monitor bookkeeping happens. A diffusing swarm takes its
Brownian kicks after the drag integration (``dust.diffuse_dust``).
``debug_nans`` checks the state after each step (``state.check_finite``).

PVTE refreshes. The JAX package memoizes ``pvte_vals`` per (sigma,
energy) within one trace, and each miss warm-starts from the previous
refresh (the chain, float32 only). Here the memo is a list keyed on tensor
identity, cleared after each CFL and each step; ``advance_to`` keeps it
from the CFL into its step, as one ``lax.while_loop`` body does. So a
step driven by ``calculate_time_step`` + ``step_once`` refreshes three
times and one of ``run`` twice, in both packages.

The time loop is a host loop with one host sync per step: the decision
whether the step lands on the output time. FLD adds one read per block of
SOR sweeps, a due self-gravity kernel refresh one read.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch import nn

from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .nbody.system import BodyConfig, NBodyState
from .ops import accretion, artvisc, boundary, cfl as cfl_ops, eos, \
    gravity, kernels, quantities as quant, sources as src_ops, \
    viscosity as visc_ops
from .ops.damping import DampingZones
from .ops import energy as energy_ops
from .ops.boundary import RefValues
from .ops.common import ring_col
from .ops.fld import FLDConfig, FLDSolver
from .ops.pvte import PVTE
from .ops.selfgravity import SelfGravity
from .params import Physics, LEAPFROG, ARTVISC_SN, ARTVISC_TW
from .particles import dust
from .state import (FieldState, MonitorAccum, SystemState, N_ECC_STAGES,
                    N_MASS_DELTA,
                    MD_DAMP_IN_CREATE, MD_FLOOR_CREATE, MD_INNER_IN,
                    MD_INNER_OUT, MD_OUTER_IN, MD_OUTER_OUT, check_finite)


def bessel_sg(phys: Physics) -> bool:
    """Bessel-kernel self-gravity, whose vertical structure adjusts the
    scale height (the JAX package's test, fargocpt_tpu/step.py:476)."""
    return phys.self_gravity and phys.self_gravity_mode == "besselkernel"


def gates(phys: Physics) -> dict[str, bool]:
    """Which fused op each substep takes: the JAX package's
    ``_fuse_sources``, ``_fuse_visc`` and ``_fuse_cfl``
    (fargocpt_tpu/step.py:244-304) without the TPU-only terms, and
    ``artvisc_sn``: the Stone-Norman substep of the unfused branch, which
    the JAX package runs as jnp there and the port as its kernel."""
    bessel = bessel_sg(phys)
    sources = (not phys.variable_gamma and not phys.is_polytropic
               and phys.aspectratio_mode == 0 and not bessel)
    viscous_kick = (
        (phys.is_adiabatic or phys.is_isothermal)
        and not phys.variable_gamma
        and phys.aspectratio_mode == 0 and phys.alpha_mode == 0
        and phys.stabilize_viscosity == 0
        and phys.artificial_viscosity in (ARTVISC_SN, ARTVISC_TW, "none")
        and not phys.heating_star and not phys.cooling_surface_enabled
        and not energy_ops.beta_or_scurve_cooling(phys)
        and not phys.cooling_beta_reference
        and not phys.write_ecc_changes and not bessel)
    cfl = (not phys.variable_gamma and not phys.is_polytropic
           and phys.alpha_mode == 0 and phys.stabilize_viscosity != 2
           and phys.aspectratio_mode == 0 and not bessel)
    return {"sources": sources, "viscous_kick": viscous_kick, "cfl": cfl,
            "artvisc_sn": (not viscous_kick
                           and phys.artificial_viscosity == ARTVISC_SN)}


def make_ref_values(fields: FieldState) -> RefValues:
    return RefValues(sigma0=fields.sigma, energy0=fields.energy,
                     vrad0=fields.vrad, vaz0=fields.vaz)


class HydroStep(nn.Module):
    """Step and CFL callables for one configuration. The geometry columns,
    the kernels' column table and the reference values are buffers:
    ``.to(device)`` moves every one of them. The PVTE, FLD and
    self-gravity solvers hold their tensors on ``device`` from the start.
    ``quad_moment`` is the binary quadrupole moment of the v_az support
    that the initial conditions took (``Simulation`` computes it)."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, *, dtype: torch.dtype,
                 device: torch.device | str, quad_moment: float = 0.0,
                 units=None,
                 transport_route: str | None = None,
                 particle_params: dust.ParticleParams | None = None,
                 shared_from: HydroStep | None = None):
        super().__init__()
        bodies = bodies if bodies is not None else \
            [BodyConfig(name="DefaultStar", mass=phys.hydro_center_mass)]
        boundary.check_supported(phys)
        self.bodies_cfg = bodies
        self.geometry = geometry
        self.phys = phys
        self.constants = constants
        self.units = units
        self.dtype = dtype
        self.n_bodies = len(bodies)
        self.n_hydroframe = n_hydroframe
        self.gates = gates(phys)
        self.ops = kernels.KernelContext(phys, constants, geometry, dtype,
                                         device, transport_route)
        # the cells' Cartesian centres, which the N-body aspect ratio, the
        # per-cell alpha and the boundary's disk model read
        cell_x, cell_y = self.ops.cell_xy()
        self.register_buffer("cell_x", cell_x)
        self.register_buffer("cell_y", cell_y)
        # the centerofmass boundary's quadrupole support
        # (fargocpt_tpu/step.py:193-198)
        self.quad_moment = quad_moment
        # per-body ramp-up times (ramp-up periods x the period of the initial
        # orbit) and cubic smoothing factors, float64 as the bodies are
        # (fargocpt_tpu/step.py:156-161)
        periods = [2.0 * math.pi * math.sqrt(
            b.semi_major_axis ** 3 / (constants.G * phys.hydro_center_mass))
            if b.semi_major_axis > 0 else 0.0 for b in bodies]
        # the initial orbital periods as floats: the Roche-lobe tracker's
        # averaging time (fargocpt_tpu/step.py:168-178 body_period_host)
        self.body_period_host = periods
        self.register_buffer("body_ramp_time", torch.tensor(
            [b.ramp_up_time for b in bodies], dtype=torch.float64,
            device=device) * torch.tensor(periods, dtype=torch.float64,
                                          device=device))
        self.register_buffer("body_cubic_factor", torch.tensor(
            [b.cubic_smoothing_factor for b in bodies], dtype=torch.float64,
            device=device))
        self.any_cubic = any(b.cubic_smoothing_factor != 0.0 for b in bodies)
        # the eccentricity-change monitor's integration radius, and that of
        # the disk mass KeepDiskMassConstant holds
        self.ecc_radius_limit = 2.0 * geometry.rmax
        self.rmax = geometry.rmax
        # the user's boundary function of a ``custom`` side
        # (CustomBoundaryModule; ``Simulation`` loads it): custom_bc(g,
        # sigma, vrad, vaz, energy, omega_frame) -> (sigma, vrad, vaz,
        # energy), applied after the named boundaries
        self.custom_bc = None
        # accretion onto the bodies, in the field type as the JAX package
        # holds the efficiencies (fargocpt_tpu/step.py:162-167)
        self.accretion_types = [b.accretion_type for b in bodies]
        self.any_accretion = phys.calculate_disk and any(
            t != "none" for t in self.accretion_types)
        self.register_buffer("body_accretion_efficiency", torch.tensor(
            [b.accretion_efficiency for b in bodies], dtype=dtype,
            device=device))
        self.damping = DampingZones(phys, constants, geometry, dtype,
                                    device) if phys.damping else None
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            self.register_buffer(
                f"ref_{name}", getattr(ref_values, name).to(device, dtype))
        needs_units = phys.variable_gamma or phys.cooling_surface_enabled \
            or phys.radiative_diffusion or phys.integrate_particles \
            or phys.heating_star or phys.cooling_scurve_enabled \
            or phys.cooling_beta_method != "no" or phys.rochelobe_overflow
        if needs_units and units is None:
            raise ValueError("PVTE, surface and S-curve cooling, the "
                             "Ziampras beta, FLD, irradiation, the dust and "
                             "the Roche-lobe stream need the run's units")
        # the irradiating bodies, in the field type as the JAX package
        # holds them (fargocpt_tpu/step.py:152-161)
        self.body_irradiates = [b.irradiate for b in bodies]
        for name, attr in (("body_radius", "radius"),
                           ("body_temperature", "temperature"),
                           ("body_irradiation_rampup", "irradiation_rampup")):
            self.register_buffer(name, torch.tensor(
                [getattr(b, attr) for b in bodies], dtype=dtype,
                device=device))
        # the in-kick viscosity grid and scale height that an adiabatic run
        # reads after a fused viscous kick (the unfused substeps return
        # them anyway; a locally isothermal grid is the current one): the
        # viscous v_rad boundary, viscous damping, the leapfrog's kick-2
        # smoothing and its second-half viscous accretion
        self.in_kick = (self.gates["viscous_kick"] and phys.is_adiabatic
                        and ("viscous" in (phys.bc_vrad_inner,
                                           phys.bc_vrad_outer)
                             or (phys.damping and phys.damping_vradial_inner
                                 == "viscous")
                             or phys.hydro_integrator == LEAPFROG))
        self.particle_params = particle_params or dust.ParticleParams()
        self.dust_grid = dust.DustGrid(geometry, dtype, device) \
            if phys.integrate_particles else None
        # a rank's window stepper (``shared_from`` the whole grid's) keeps
        # the global PVTE tables and self-gravity solver
        self.pvte = shared_from.pvte if shared_from is not None else \
            PVTE(phys, units, dtype, device) if phys.variable_gamma else None
        # the JAX package builds no FLD solver for a non-adiabatic EoS
        # (fargocpt_tpu/step.py:222)
        self.fld = FLDSolver(
            phys, constants, units, geometry,
            # the reference scales the tolerance by the temperature floor
            # (src/fld.cpp:235-237)
            FLDConfig(tolerance=phys.fld_tolerance * phys.minimum_temperature,
                      max_iterations=phys.fld_max_iterations,
                      omega=phys.fld_omega, auto_omega=phys.fld_auto_omega,
                      inner_boundary=phys.fld_inner_boundary,
                      outer_boundary=phys.fld_outer_boundary,
                      constant_fluxlimiter=phys.fld_constant_fluxlimiter,
                      check_interval=phys.fld_check_interval),
            dtype, device) \
            if phys.radiative_diffusion and phys.is_adiabatic else None
        self.selfgravity = shared_from.selfgravity \
            if shared_from is not None else \
            SelfGravity(phys, constants, geometry, dtype, device) \
            if phys.self_gravity else None
        self._pv_memo: list = []
        self._pv_chain = None
        self._memo_shared = False
        # the NaN trap (--debug-nans): a finiteness check after each step
        self.debug_nans = False
        # the radial decomposition's hooks; a rank's window stepper
        # (``parallel/shard_step.py``) sets them (fargocpt_tpu/step.py:
        # 313-348), one process keeps the whole grid's values below:
        #   comm            the ranks' Communicator (the JAX axis name)
        #   _own_col        (Lx, 1) 1.0 where the window row is owned
        #   _own_int_col    owned and global rows [1, NR-2]
        #   _own_act_col    owned and global rows [2, NR-2] (accretion)
        #   _inner_face     (window index of global face 1, weight)
        #   _outer_face     (window index of global face NR-1, weight)
        #   _halo_refresh   state -> state with fresh halo rows
        #   _fld_halo_fn    FLD's ghost refresh of one grid, each SOR sweep
        #   _fld_shard_ctx  FLD's global red-black masks, norm rows, sum
        #   _sg_gather      window sigma -> the global grid (all_gather)
        #   _sg_window      global accelerations -> the window's rows
        #   _particle_shard_ctx  slab-owned buckets: bounds, exchange size
        #   _particle_gather, _global_stepper  the replicated swarm:
        #                   global fields, and the stepper that moves it
        self.comm = None
        self._own_col = torch.ones((geometry.nrad, 1), dtype=dtype,
                                   device=device)
        self._own_int_col = ring_col(self.g, 1)
        self._own_act_col = ring_col(self.g, 2)
        self._inner_face = (1, 1.0)
        self._outer_face = (geometry.nrad - 1, 1.0)
        self._halo_refresh = None
        self._fld_halo_fn = self._fld_shard_ctx = None
        self._sg_gather = self._sg_window = None
        self._particle_shard_ctx = None
        self._particle_gather = self._global_stepper = None

    @property
    def g(self):
        return self.ops.g

    def set_ref_values(self, ref: RefValues) -> None:
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            getattr(self, f"ref_{name}").copy_(getattr(ref, name))

    @property
    def device(self) -> torch.device:
        return self.ops.cols.device

    # ------------------------------------------------------------------
    @contextmanager
    def _pvte_scope(self, guess):
        """The chain starts at ``guess``; the memo is cleared at the end
        unless ``advance_to`` shares it between a CFL and its step."""
        self._pv_chain = guess
        try:
            yield
        finally:
            self._pv_chain = None
            if not self._memo_shared:
                self._pv_memo.clear()

    @contextmanager
    def detached(self, guess=None):
        """A PVTE scope apart from any step in progress, for diagnostics
        between or during steps (the output, a signal's report): refreshes
        warm from ``guess``, and the memo and chain of the step are put
        back afterwards, so a diagnostic never changes the trajectory."""
        saved = self._pv_memo, self._pv_chain, self._memo_shared
        self._pv_memo, self._memo_shared = [], False
        try:
            with self._pvte_scope(guess):
                yield
        finally:
            self._pv_memo, self._pv_chain, self._memo_shared = saved

    def pvte_vals(self, sigma, energy):
        """(gamma_eff, mu, gamma1) of (sigma, energy), refreshed once per
        distinct pair within a scope; the midplane density takes H from
        the constant-gamma sound speed (reference
        src/SourceEuler.cpp:238-246). None without PVTE."""
        if self.pvte is None:
            return None
        for s, e, vals in self._pv_memo:
            if s is sigma and e is energy:
                return vals
        phys = self.phys
        gam0 = phys.adiabatic_index
        cs0 = torch.sqrt(gam0 * (gam0 - 1.0) * energy / sigma)
        omega_k = torch.sqrt(self.constants.G * phys.hydro_center_mass
                             / self.g.rb ** 3)
        h0 = cs0 / math.sqrt(gam0) / omega_k
        vals = self.pvte.gamma_mu(sigma, energy, h0, guess=self._pv_chain)
        if self.pvte.fast:
            self._pv_chain = (vals[0], vals[1])
        self._pv_memo.append((sigma, energy, vals))
        return vals

    def derived(self, sigma, energy, bodies=None, pv=None):
        """Sound speed, pressure and scale height; ``pv`` are stale PVTE
        grids to use instead of a refresh. Under AspectRatioMode 1 / 2 and
        given ``bodies`` (``bodies_on_grid``), the N-body / centre-of-mass
        forms (reference src/SourceEuler.cpp:1054-1441); without them the
        axisymmetric mode-0 forms, as the JAX package's callers without the
        bodies take them (fargocpt_tpu/step.py:425-476). Under Bessel-kernel
        self-gravity H takes the disk's Toomre Q."""
        if pv is None:
            pv = self.pvte_vals(sigma, energy)
        phys, constants, g = self.phys, self.constants, self.g
        mode = phys.aspectratio_mode
        if mode not in (1, 2) or bodies is None:
            cs, press, h = kernels.derived(self.ops, sigma, energy, pv)
        else:
            cs, press, h = self._derived_bodies(sigma, energy, bodies, pv)
        if bessel_sg(phys):
            # the self-gravitating vertical structure (reference
            # src/SourceEuler.cpp:1434-1439; fargocpt_tpu/step.py:474-479)
            h = eos.adjust_scale_height_for_sg(
                h, quant.toomre_q(phys, constants, g, sigma, cs))
        return cs, press, h

    def _derived_bodies(self, sigma, energy, bodies, pv):
        """``derived`` of AspectRatioMode 1 / 2 given the bodies."""
        phys, constants, g = self.phys, self.constants, self.g
        mode = phys.aspectratio_mode
        cx, cy = self.cell_x, self.cell_y
        if mode == 2:
            com_x, com_y, com_m = eos.center_of_mass(bodies)
        if phys.is_adiabatic or phys.is_polytropic:
            cs = eos.sound_speed(phys, constants, g, sigma, energy,
                                 self.ops.cs_iso, pv)
        elif mode == 1:
            cs = eos.sound_speed_iso_nbody(phys, constants, g, bodies,
                                           self.n_bodies, self.body_radius,
                                           cx, cy)
        else:
            cs = eos.sound_speed_iso_com(phys, constants, g, com_x, com_y,
                                         com_m, cx, cy)
        press = eos.pressure(phys, constants, sigma, energy, cs, pv)
        if mode == 1:
            h = eos.scale_height_nbody(phys, constants, g, cs, bodies,
                                       self.n_bodies, self.body_radius, cx,
                                       cy, pv)
        else:
            h = eos.scale_height_com(phys, constants, g, cs, com_x, com_y,
                                     com_m, cx, cy, pv)
        return cs, press, h

    def viscosity_grid(self, cs, h, sigma=None, energy=None, bodies=None):
        """The viscosity grid; under AlphaMode != 0, given the fields (and
        for mode 2 the bodies), with the per-cell alpha (reference
        src/viscosity/viscosity.cpp:31-137; fargocpt_tpu/step.py:482-496)."""
        phys = self.phys
        if phys.alpha_mode != 0 and sigma is not None and energy is not None:
            temp = eos.temperature(phys, self.constants, sigma, energy, None,
                                   self.pvte_vals(sigma, energy))
            return visc_ops.kinematic_viscosity(
                phys, self.g, cs, h, temperature=temp, units=self.units,
                sigma=sigma, bodies=bodies,
                n_bodies=self.n_bodies if bodies is not None else 0,
                cell_x=self.cell_x, cell_y=self.cell_y)
        return visc_ops.kinematic_viscosity(phys, self.g, cs, h)

    def aspect_grid(self, cs, h, bodies, pvte_vals=None):
        """The reference's ASPECTRATIO grid (src/SourceEuler.cpp:1272-1341,
        :1380-1396; fargocpt_tpu/step.py:602-615): H / r in mode 0, the
        N-body sum in mode 1, the centre-of-mass form in mode 2. The
        irradiation's H/R factor reads it."""
        phys = self.phys
        if phys.aspectratio_mode == 1 and bodies is not None:
            return eos.aspect_ratio_nbody(
                phys, self.constants, self.g, cs, bodies, self.n_bodies,
                self.body_radius, self.cell_x, self.cell_y, pvte_vals)
        if phys.aspectratio_mode == 2 and bodies is not None:
            com_x, com_y, com_m = eos.center_of_mass(bodies)
            return eos.aspect_ratio_com(
                phys, self.constants, self.g, cs, com_x, com_y, com_m,
                self.cell_x, self.cell_y, pvte_vals)
        return h * self.g.inv_rb

    def bodies_on_grid(self, nb: NBodyState, time) -> gravity.BodiesOnGrid:
        """Body data the gas-side ops need at ``time`` (a float or a 0-d
        tensor): the masses ramped up, and the Klahr cubic smoothing radius
        (Roche radius x distance to the primary x the body's factor); all
        float64 tensors on the device (fargocpt_tpu/step.py:498-509)."""
        if self.n_bodies == 1:
            # a lone star: no orbit to ramp its mass over, no Roche lobe
            return gravity.BodiesOnGrid(
                x=nb.x, y=nb.y, mass=nb.mass,
                cubic_smoothing_radius=torch.zeros_like(nb.x))
        mass = nbody_sys.rampup_masses(nb, self.body_ramp_time, time)
        if self.any_cubic:
            cubic = nbody_sys.dimensionless_roche_radius(nb) \
                * nbody_sys.dist_to_primary(nb) * self.body_cubic_factor
        else:
            # no cubic smoothing: the finite Roche radii times zero factors
            cubic = torch.zeros_like(nb.x)
        return gravity.BodiesOnGrid(x=nb.x, y=nb.y, mass=mass,
                                    cubic_smoothing_radius=cubic)

    def disk_torques(self, state: SystemState, time=0.0) -> torch.Tensor:
        """Torque of the gas disk on each body, m_k (x_k a_y - y_k a_x)
        (reference src/output.cpp ``write_torques`` path via
        ComputeDiskOnNbodyAccel); call it inside ``detached``."""
        f, nb = state.fields, state.nbody
        _, _, h = self.derived(f.sigma, f.energy)
        cell_x, cell_y = self.cell_x, self.cell_y
        ax, ay = gravity.disk_on_body_accel(
            self.phys, self.constants, self.g, self.bodies_on_grid(nb, time),
            self.n_bodies, cell_x, cell_y, h, f.sigma)
        return nb.mass * (nb.x * ay.to(nb.x.dtype) - nb.y * ax.to(nb.x.dtype))

    def ref_values(self) -> RefValues:
        return RefValues(sigma0=self.ref_sigma0, energy0=self.ref_energy0,
                         vrad0=self.ref_vrad0, vaz0=self.ref_vaz0)

    # --- reductions over the grid, summed over the ranks when sharded ---
    def _sum_cells(self, x, weight_col):
        """The sum of ``x`` times the row weight, over the ranks when
        sharded (fargocpt_tpu/step.py:365-374)."""
        s = torch.sum(x * weight_col)
        return self.comm.sum(s) if self.comm is not None else s

    def _face_row(self, flux, which: str):
        """Global face 1 (``which`` "inner") or NR-1 ("outer") of a face
        array; when sharded the rank holding it adds it, the others zero
        (fargocpt_tpu/step.py:376-385)."""
        idx, w = self._inner_face if which == "inner" else self._outer_face
        if self.comm is None:
            return flux[idx]
        return self.comm.sum(flux[idx] * w)

    def _sg_accels(self, sigma, spectra=None):
        """The self-gravity accelerations; when sharded the FFT runs on
        the all-gathered global sigma and the window's rows are kept
        (fargocpt_tpu/step.py:831-841)."""
        if self._sg_gather is None:
            return self.selfgravity.accelerations(sigma, spectra)
        g_r, g_t = self.selfgravity.accelerations(self._sg_gather(sigma),
                                                  spectra)
        return self._sg_window(g_r), self._sg_window(g_t)

    def _nu_now(self, sigma, energy):
        cs, _, h = self.derived(sigma, energy)
        return self.viscosity_grid(cs, h)

    def _accretion_nu(self, sigma, energy, bodies):
        """The viscosity grid the viscous accretion reads: the per-cell one
        of the fields and the bodies (fargocpt_tpu/step.py:510-516)."""
        cs, _, h = self.derived(sigma, energy, bodies)
        return self.viscosity_grid(cs, h, sigma, energy, bodies)

    def rof_averaging_time(self) -> float:
        """The Roche-lobe tracker's averaging time: ROFaveragingtime orbits
        of the donor's initial orbit (fargocpt_tpu/step.py:1509-1511)."""
        phys = self.phys
        if self.n_bodies > 1:
            return max(self.body_period_host[phys.rof_planet]
                       * phys.rof_averaging_time, 1e-12)
        return 1e-12

    def _rescale_to_initial_mass(self, sigma):
        """KeepDiskMassConstant: sigma scaled so the disk's mass inside
        Rmax stays the initial one (reference src/simulation.cpp:246-251,
        :476-481; fargocpt_tpu/step.py:1136-1146)."""
        m0 = quant.total_mass(self.phys, self.g, self.ref_sigma0, self.rmax,
                              self._own_int_col, self.comm)
        m_new = quant.total_mass(self.phys, self.g, sigma, self.rmax,
                                 self._own_int_col, self.comm)
        return sigma * (m0 / m_new)

    def _apply_bcs(self, sigma, vrad, vaz, energy, omega_frame, nu=None,
                   final: bool = False, dt=None, nb=None, time=0.0,
                   rof_mdot=None):
        """The boundary conditions (fargocpt_tpu/step.py:518-599); on the
        final application of a step (``final``) the damping zones first.
        ``nu`` is the viscosity grid of the step's viscous substep, which
        the viscous v_rad BC and viscous damping read (the reference's
        data[VISCOSITY]); without it viscous damping takes the current
        fields' mode-0 grid, and the viscous BC the per-cell one of the
        bodies ``nb`` at ``time`` under AlphaMode or AspectRatioMode, as
        the JAX package takes them. ``nb`` also feeds a ``centerofmass``
        side and the Roche-lobe stream at ``time``, whose rate is
        ``ROFvalue``, or the tracked ``rof_mdot`` under ROFVariableTransfer.
        The user's ``custom_bc`` follows on a ``custom`` side. Returns the
        fields and the (4,) damping mass deltas (zeros without damping)."""
        phys = self.phys
        ref = self.ref_values()
        dmp = torch.zeros(4, dtype=sigma.dtype, device=sigma.device)
        if final and self.damping is not None:
            dmp_nu = nu
            if dmp_nu is None and phys.damping_vradial_inner == "viscous":
                dmp_nu = self._nu_now(sigma, energy)
            sig_before = sigma
            sigma, vrad, vaz, energy = self.damping.apply(
                phys, sigma, vrad, vaz, energy, ref, dt, nu=dmp_nu)
            if sigma is not sig_before:
                dmp = self.damping.mass_deltas(self.g, sig_before, sigma,
                                               self._own_col, self.comm)
        if nu is None and "viscous" in (phys.bc_vrad_inner,
                                        phys.bc_vrad_outer):
            nu_bodies = self.bodies_on_grid(nb, time) \
                if nb is not None and (phys.alpha_mode != 0
                                       or phys.aspectratio_mode in (1, 2)) \
                else None
            cs, _, h = self.derived(sigma, energy, nu_bodies)
            nu = self.viscosity_grid(cs, h, sigma, energy, nu_bodies)
        rof_ctx = None
        if phys.rochelobe_overflow and nb is not None:
            un = self.units
            mdot = rof_mdot if phys.rof_variable_transfer \
                and rof_mdot is not None else phys.rof_mdot
            rof_ctx = (nb, time, un.temperature, un.time / 3600.0,
                       un.length, mdot)
        com_ctx = (nb, self.n_hydroframe, self.quad_moment) \
            if nb is not None else None
        fields = boundary.apply_boundary_conditions(
            phys, self.constants, self.g, sigma, vrad, vaz, energy, ref,
            omega_frame, nu=nu, rof_ctx=rof_ctx, com_ctx=com_ctx)
        if self.custom_bc is not None and "custom" in (phys.composite_inner,
                                                       phys.composite_outer):
            fields = self.custom_bc(self.g, *fields, omega_frame)
        return (*fields, dmp)

    def apply_bcs(self, fields: FieldState,
                  nb: NBodyState | None = None) -> FieldState:
        """Standalone BC application (at init, reference
        src/init.cpp:337-341); ``nb`` feeds the boundaries that read the
        bodies."""
        omega = torch.tensor(self.phys.omega_frame, dtype=self.dtype,
                             device=fields.sigma.device)
        sigma, vrad, vaz, energy, _ = self._apply_bcs(
            fields.sigma, fields.vrad, fields.vaz, fields.energy, omega,
            nb=nb)
        return FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy)

    def _integrate_particles(self, sigma, vrad, vaz, energy, nb, particles,
                             omega_frame, dt, time):
        """Drag + gravity integration of the swarm against the given gas
        fields, then the diffusion kicks (fargocpt_tpu/step.py:1274-1304).
        The temperature is the one the reference's particles sample
        (per-cell gamma and mu with PVTE): for the step-start fields the
        PVTE grids come from the memo, with no refresh of their own.
        When sharded, a rank moves its slot bucket against its window and
        migrates the crossers (``particles/sharded.py``), or the whole
        replicated swarm against the all-gathered global fields with the
        global stepper (fargocpt_tpu/step.py:1254-1270)."""
        if self._particle_shard_ctx is not None:
            from .particles import sharded as psh
            return psh.integrate_bucket(self, sigma, vrad, vaz, energy, nb,
                                        particles, omega_frame, dt, time)
        if self._particle_gather is not None:
            sigma, vrad, vaz, energy = self._particle_gather(sigma, vrad,
                                                             vaz, energy)
            glob = self._global_stepper
            with glob.detached(None):
                return glob._particle_core(sigma, vrad, vaz, energy, nb,
                                           particles, omega_frame, dt, time)
        return self._particle_core(sigma, vrad, vaz, energy, nb, particles,
                                   omega_frame, dt, time)

    def _particle_core(self, sigma, vrad, vaz, energy, nb, particles,
                       omega_frame, dt, time):
        """``_integrate_particles`` against this stepper's own grid (the
        whole grid, or a rank's window)."""
        phys, constants = self.phys, self.constants
        pp = self.particle_params
        cs0, press, h0 = self.derived(sigma, energy)
        temp = eos.temperature(phys, constants, sigma, energy, press,
                               self.pvte_vals(sigma, energy))
        rho_mid = sigma / (phys.density_factor * h0)
        integ = dust.integrate_rk45 if pp.integrator.startswith(
            ("e", "a", "r")) else dust.integrate_expmid
        sg_accel = None
        if pp.disk_gravity and self.selfgravity is not None:
            sg_accel = self._sg_accels(sigma)
        particles = integ(phys, pp, constants, self.units, self.dust_grid,
                          particles, rho_mid, temp, vrad, vaz,
                          self.bodies_on_grid(nb, time), self.n_bodies,
                          omega_frame, dt, sg_accel=sg_accel)
        if pp.diffusion:
            particles = dust.diffuse_dust(phys, constants, self.dust_grid,
                                          self.g, particles, rho_mid, cs0,
                                          h0, dt)
        return particles

    def irradiation_ctx(self, bodies: gravity.BodiesOnGrid):
        """What SubStep3's stellar irradiation reads (the JAX package's
        ``irradiation_ctx``, fargocpt_tpu/step.py:621-627); None without
        an irradiating body."""
        if not self.phys.heating_star:
            return None
        cell_x, cell_y = self.cell_x, self.cell_y
        return energy_ops.IrradiationCtx(
            bodies=bodies, radius=self.body_radius,
            temperature=self.body_temperature,
            irradiates=self.body_irradiates,
            rampup=self.body_irradiation_rampup, cell_x=cell_x,
            cell_y=cell_y)

    # ------------------------------------------------------------------
    def _substeps(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies, sg_kernel, stale_h=None,
                  stale_derived=None):
        """Self-gravity, sources, viscosity and energy (the 'kick';
        fargocpt_tpu/step.py:662-829). ``stale_h`` is the scale height the
        N-body potential's smoothing takes in place of the current one
        (the leapfrog's kicks); ``stale_derived`` the (cs, pressure, H)
        of the fields before this step's accretion, which an accreting
        step's first kick reads in place of the current ones (the
        reference refreshes them at the end of a step only).
        Returns (vrad, vaz, energy, qplus, qminus, sg_kernel, pv_last, h,
        nu, ecc): pv_last the PVTE grids of SubStep3, h and nu the scale
        height and viscosity grid of the viscous substep (None after the
        fused viscous kick unless ``self.in_kick``), ecc the disk's (e,
        peri) changes of the sources, the artificial viscosity and the
        viscosity (WriteEccentricityChange; None otherwise)."""
        phys, constants, g, ops = self.phys, self.constants, self.g, self.ops
        fused = self.gates
        # the sources kernel derives the pressure from the current fields,
        # so a kick that reads the pre-accretion pressure takes the plain
        # substep (the JAX package's gate, fargocpt_tpu/step.py:719-722)
        fused_sources = fused["sources"] and stale_derived is None
        ecc = [] if phys.write_ecc_changes else None
        mark = self._disk_ecc_peri(sigma, vrad, vaz, omega_frame) \
            if ecc is not None else None
        pv = self.pvte_vals(sigma, energy)
        if stale_derived is not None:
            cs, press, h = stale_derived
        elif self.selfgravity is not None or not fused_sources:
            cs, press, h = self.derived(sigma, energy, bodies, pv=pv)

        # self-gravity kick first (reference src/SourceEuler.cpp:438-441)
        if self.selfgravity is not None:
            spectra = None
            if sg_kernel is not None:
                sg_kernel = self.selfgravity.update_kernel(
                    sg_kernel, sigma, h, g, self._own_col, self.comm)
                spectra = sg_kernel[:2]
            g_r, g_t = self._sg_accels(sigma, spectra)
            vrad, vaz = self.selfgravity.kick(g, vrad, vaz, g_r, g_t, dt)

        if fused_sources:
            vrad, vaz = kernels.sources(ops, sigma, vrad, vaz, energy, bodies,
                                        pot_it, omega_frame, dt,
                                        h_smooth=stale_h)
            if not fused["viscous_kick"]:
                energy = src_ops.compression_heating(phys, g, energy, vrad,
                                                     vaz, dt)
        else:
            cell_x, cell_y = self.cell_x, self.cell_y
            pot = gravity.nbody_potential(phys, constants, g, bodies,
                                          self.n_bodies, cell_x, cell_y,
                                          h if stale_h is None else stale_h,
                                          pot_it[0], pot_it[1])
            vrad, vaz, energy = src_ops.update_with_sourceterms(
                phys, g, sigma, press, pot, vrad, vaz, energy,
                omega_frame.to(sigma.dtype), dt, pvte_vals=pv)
        if ecc is not None:
            mark = self._ecc_delta(ecc, mark, sigma, vrad, vaz, omega_frame)

        if fused["viscous_kick"]:
            out = kernels.viscous_kick(ops, sigma, vrad, vaz, energy, dt,
                                       time, compress=fused_sources,
                                       want_cs=self.in_kick)
            h_kick = nu_kick = None
            if self.in_kick:
                # h and nu of the in-kick cs, by the ops of the unfused
                # path's ``derived`` and ``viscosity_grid``
                h_kick = eos.scale_height(phys, constants, g, out[5])
                nu_kick = self.viscosity_grid(out[5], h_kick)
            return (*out[:5], sg_kernel, None, h_kick, nu_kick, None)

        if fused["artvisc_sn"]:
            vrad, vaz, energy = kernels.artvisc_sn(ops, sigma, vrad, vaz,
                                                   energy, dt)
        else:
            vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
                phys, g, sigma, vrad, vaz, energy, dt)
        if ecc is not None:
            mark = self._ecc_delta(ecc, mark, sigma, vrad, vaz, omega_frame)
        if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
            # the step-start PVTE grids, as the reference's floor reads
            # pvte::get_* of the last compute_gamma_mu
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                              pv)

        # recalculate_viscosity (reference src/SourceEuler.cpp:205-223),
        # the scale height of the bodies' present positions under
        # AspectRatioMode 1 / 2 (src/simulation.cpp:328/383)
        cs, _, h = self.derived(sigma, energy, bodies)
        nu = self.viscosity_grid(cs, h, sigma, energy, bodies)
        trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
            phys, g, sigma, vrad, vaz, nu)
        vrad, vaz = visc_ops.update_velocities_with_viscosity(
            phys, g, sigma, vrad, vaz, trr, tpp, trp, dt, nu=nu)
        if ecc is not None:
            self._ecc_delta(ecc, mark, sigma, vrad, vaz, omega_frame)

        qplus = qminus = torch.zeros_like(sigma)
        pv3 = None
        if phys.is_adiabatic:
            pv3 = self.pvte_vals(sigma, energy)
            energy, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
                time, dt, units=self.units, pvte_vals=pv3,
                ref=(self.ref_sigma0, self.ref_energy0),
                irradiation_ctx=self.irradiation_ctx(bodies),
                aspect_grid=self.aspect_grid(cs, h, bodies, pv3)
                if phys.heating_star else None)
        return vrad, vaz, energy, qplus, qminus, sg_kernel, pv3, h, nu, ecc

    def _gas_kick(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies, sg_kernel, sor, stale_h=None,
                  stale_derived=None):
        """The substeps, then FLD radiative diffusion on the stale PVTE
        grids of SubStep3 (reference fld.cpp:996-1000 reads pvte::get_*
        with no refresh; fargocpt_tpu/step.py:911-934). Returns (vrad,
        vaz, energy, qplus, qminus, sg_kernel, sor, h, nu, ecc), h, nu and
        ecc as ``_substeps`` gives them."""
        (vrad, vaz, energy, qplus, qminus, sg_kernel, pv_last, h_kick,
         nu_kick, ecc) = self._substeps(sigma, vrad, vaz, energy, pot_it,
                                        time, dt, omega_frame, bodies,
                                        sg_kernel, stale_h, stale_derived)
        if self.fld is not None:
            energy, sor = self._fld(sigma, energy, dt, sor, pv_last)
        return (vrad, vaz, energy, qplus, qminus, sg_kernel, sor, h_kick,
                nu_kick, ecc)

    def _fld(self, sigma, energy, dt, sor, pv):
        """FLD radiative diffusion, then the temperature range, both on the
        PVTE grids ``pv`` (a refresh where None; the range then takes the
        constant gamma, as the JAX package's ``Disk: no`` step does,
        fargocpt_tpu/step.py:1453-1467). Returns (energy, sor)."""
        _, _, h_now = self.derived(sigma, energy, pv=pv)
        energy, _, sor = self.fld.radiative_diffusion(
            self.g, sigma, energy, h_now, dt, sor_state=sor,
            halo_fn=self._fld_halo_fn, shard_ctx=self._fld_shard_ctx)
        energy = eos.energy_floor_ceiling(self.phys, self.constants, sigma,
                                          energy, pv)
        return energy, sor

    def _feedback_on(self) -> bool:
        """Whether the disk's force on the bodies is evaluated. On a lone
        star the disk's kick and the disk indirect term cancel and the
        frame is re-centred on it each step, so its force is evaluated only
        where the gas potential takes the disk indirect term
        (IndirectTermDiskOnDisk, on with self-gravity)."""
        phys = self.phys
        return phys.disk_feedback and phys.calculate_disk and (
            self.n_bodies > 1 or phys.indirect_term_disk_on_disk)

    def _disk_feedback(self, sigma, h, bodies):
        """The disk's acceleration of each body and the disk indirect term
        (reference src/Force.cpp:23-122, src/frame_of_reference.cpp:69-93):
        (dax, day, (it_x, it_y)); (None, None, zeros) where
        ``_feedback_on`` is false."""
        zero = torch.zeros((), dtype=torch.float64, device=sigma.device)
        if not self._feedback_on():
            return None, None, (zero, zero)
        cell_x, cell_y = self.cell_x, self.cell_y
        dax, day = gravity.disk_on_body_accel(
            self.phys, self.constants, self.g, bodies, self.n_bodies, cell_x,
            cell_y, h, sigma, self._own_int_col, self.comm)
        return dax, day, gravity.indirect_term_disk(bodies, self.n_hydroframe,
                                                    dax, day)

    def _indirect_nbody(self, nb: NBodyState, bodies, dt):
        """The N-body indirect term (reference src/simulation.cpp:160-166):
        mode 0 integrates ``nb`` ahead by ``dt`` with IAS15, mode 1 the
        Euler sum over ``bodies``."""
        if self.phys.indirect_term_mode == 0:
            return gravity.indirect_term_nbody_predictor(
                self.constants, nb, self.n_hydroframe, self.n_bodies, dt)
        return gravity.indirect_term_nbody(self.constants, bodies,
                                           self.n_hydroframe, self.n_bodies)

    def _pot_indirect(self, it_disk, it_nb):
        """The indirect term of the gas potential (reference :168-176)."""
        if self.phys.indirect_term_disk_on_disk:
            return it_disk[0] + it_nb[0], it_disk[1] + it_nb[1]
        return it_nb

    def _mass_deltas(self, state: SystemState, mass_flux, dmp,
                     floor_created=None):
        """The step's boundary, damping and (Euler) floor mass bookkeeping
        added to the run's (reference src/TransportEuler.cpp:575-608 +
        src/types.h:30-60)."""
        f_in = self._face_row(mass_flux, "inner")
        f_out = self._face_row(mass_flux, "outer")
        like = mass_flux
        inc = [torch.zeros((), dtype=like.dtype, device=like.device)] \
            * N_MASS_DELTA
        inc[MD_INNER_IN] = torch.sum(torch.clamp(f_in, min=0.0))
        inc[MD_INNER_OUT] = torch.sum(torch.clamp(-f_in, min=0.0))
        inc[MD_OUTER_IN] = torch.sum(torch.clamp(-f_out, min=0.0))
        inc[MD_OUTER_OUT] = torch.sum(torch.clamp(f_out, min=0.0))
        inc[MD_DAMP_IN_CREATE:MD_DAMP_IN_CREATE + 4] = list(dmp)
        if floor_created is not None:
            inc[MD_FLOOR_CREATE] = floor_created
        return state.monitor_acc.replace(
            mass_delta=state.monitor_acc.mass_delta + torch.stack(inc))

    def step(self, state: SystemState, time, dt) -> SystemState:
        """One hydro step by the configured integrator. The PVTE chain
        starts at ``state.pvte_guess`` and its last link is carried to the
        next step."""
        impl = self._step_leapfrog \
            if self.phys.hydro_integrator == LEAPFROG else self._step_euler
        with self._pvte_scope(state.pvte_guess):
            new_state = impl(state, time, dt)
            if state.pvte_guess is not None and self._pv_chain is not None:
                new_state = new_state.replace(pvte_guess=self._pv_chain)
        return new_state

    def _step_euler(self, state: SystemState, time, dt) -> SystemState:
        """One Euler step (reference src/simulation.cpp:148-274,
        fargocpt_tpu/step.py:1358-1530). ``dt`` and ``time`` may be 0-d
        device tensors."""
        phys, constants, g = self.phys, self.constants, self.g
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        dt = torch.as_tensor(dt, dtype=self.dtype, device=sigma.device)
        nb = state.nbody
        omega_frame = state.omega_frame
        bodies = self.bodies_on_grid(nb, time)

        # accretion onto the bodies (reference :150-153); the first kick
        # reads the derived values of the fields before it
        stale = None
        if self.any_accretion:
            stale = self.derived(sigma, energy, bodies)
            sig0, e0, bodies0 = sigma, energy, bodies
            sigma, energy, nb = self._accrete(
                nb, sigma, energy, vrad, vaz, omega_frame, dt,
                lambda: self.viscosity_grid(stale[0], stale[2], sig0, e0,
                                            bodies0))
            bodies = self.bodies_on_grid(nb, time)

        # disk feedback on the bodies (reference :154-158), then the N-body
        # indirect term of the kicked bodies (:160-166)
        h0 = None
        if self._feedback_on():
            h0 = stale[2] if stale is not None \
                else self.derived(sigma, energy, bodies)[2]
        dax, day, it_disk = self._disk_feedback(sigma, h0, bodies)
        if dax is not None:
            nb = nbody_sys.kick(nb, dax, day, dt)
        it_nb = self._indirect_nbody(nb, bodies, dt)
        nb = nbody_sys.kick(nb, it_disk[0] + it_nb[0], it_disk[1] + it_nb[1],
                            dt)
        pot_it = self._pot_indirect(it_disk, it_nb)

        # dust particles (reference :178-182 particles::integrate)
        particles = state.particles
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt,
                time)

        # the frame (reference :186 handle_corotation), measured against
        # the reference body's position at the start of the run; the
        # bodies and the particles rotate with it
        if phys.corotating:
            omega_frame, vaz = self._corotation_update(
                nb, vaz, omega_frame, dt, state.corot_ref_x,
                state.corot_ref_y)
        if phys.integrate_particles and particles is not None:
            particles = particles.replace(phi=torch.remainder(
                particles.phi - omega_frame * dt, 2.0 * math.pi))
        nb = nbody_sys.rotate(nb, omega_frame * dt)
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps and FLD; under Disk: no only FLD, which the
        # reference runs outside the disk's gate (src/simulation.cpp:205-208)
        if not phys.calculate_disk:
            sor = state.fld_sor
            if self.fld is not None:
                energy, sor = self._fld(sigma, energy, dt, sor, None)
            nb = nbody_sys.integrate(nb, constants.G, dt,
                                     method=phys.nbody_integrator)
            nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)
            return state.replace(
                fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz,
                                  energy=energy),
                nbody=nb, omega_frame=omega_frame, frame_angle=frame_angle,
                fld_sor=sor, particles=particles)
        (vrad, vaz, energy, qplus, qminus, sg_kernel, sor, _,
         nu_step, ecc) = self._gas_kick(sigma, vrad, vaz, energy, pot_it,
                                        time, dt, omega_frame, bodies,
                                        state.sg_kernel, state.fld_sor,
                                        stale_derived=stale)

        # the viscous BC reads the in-kick viscosity grid (reference
        # data[VISCOSITY] from recalculate_viscosity, :196)
        sigma, vrad, vaz, energy, _ = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step, nb=nb,
            time=time)
        if ecc is not None:
            mark = self._disk_ecc_peri(sigma, vrad, vaz, omega_frame)
        sigma, vrad, vaz, energy, mass_flux = kernels.transport(
            self.ops, sigma, vrad, vaz, energy, omega_frame, dt)
        sig_pre_floor = sigma
        sigma = eos.apply_sigma_floor(phys, sigma)
        floor_created = self._sum_cells((sigma - sig_pre_floor) * g.surf,
                                        self._own_int_col)
        if phys.is_adiabatic:
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)
        if ecc is not None:
            mark = self._ecc_delta(ecc, mark, sigma, vrad, vaz, omega_frame)

        # --- N-body drift (reference :218-221) ---
        nb = nbody_sys.integrate(nb, constants.G, dt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)

        # the Roche-lobe tracker (reference src/massflow_tracker.cpp): the
        # rate through the inner face, averaged exponentially
        # (fargocpt_tpu/step.py:1503-1515; the leapfrog keeps no tracker)
        rof_mdot = state.monitor_acc.rof_mdot
        if rof_mdot is not None:
            delta = -torch.sum(self._face_row(mass_flux, "inner"))
            alpha = torch.clamp(dt / self.rof_averaging_time(), max=1.0)
            rof_mdot = (1.0 - alpha) * rof_mdot + alpha * delta / dt

        # the final boundary conditions, the damping zones first
        sigma, vrad, vaz, energy, dmp = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step, final=True,
            dt=dt, nb=nb, time=time, rof_mdot=rof_mdot)
        if phys.keep_mass_constant:
            sigma = self._rescale_to_initial_mass(sigma)
        monitor_acc = self._mass_deltas(state, mass_flux, dmp, floor_created)
        if rof_mdot is not None:
            monitor_acc = monitor_acc.replace(rof_mdot=rof_mdot)
        if ecc is not None:
            self._ecc_delta(ecc, mark, sigma, vrad, vaz, omega_frame)
            monitor_acc = monitor_acc.replace(
                decc=monitor_acc.decc + torch.stack([d[0] for d in ecc]),
                dperi=monitor_acc.dperi + torch.stack([d[1] for d in ecc]))
        monitor_acc = self._update_monitor_acc(
            monitor_acc, mass_flux, sigma, vrad, vaz, energy, nb, time,
            pot_it, dt)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, monitor_acc=monitor_acc, fld_sor=sor,
            sg_kernel=sg_kernel, particles=particles)

    def _step_leapfrog(self, state: SystemState, time, dt) -> SystemState:
        """One leapfrog step: the gas kick-drift-kick, the bodies
        drift-kick-drift, accretion before each half's kick to the bodies
        and the frame's rate measured over each half drift (reference
        src/simulation.cpp:276-483 ``step_LeapFrog``,
        fargocpt_tpu/step.py:936-1135). ``dt`` and ``time`` may be 0-d
        device tensors."""
        phys, constants = self.phys, self.constants
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        dt = torch.as_tensor(dt, dtype=self.dtype, device=sigma.device)
        nb = state.nbody
        omega_frame = state.omega_frame
        hdt = 0.5 * dt
        mid_time = time + hdt

        # N-body drift 1/2; kick 1's N-body indirect term looks ahead from
        # the bodies before the drift (reference :287-291). Accretion's
        # orbital periods are sampled once, after this drift, for both
        # halves (:292)
        nb_pre_drift = nb
        nb = nbody_sys.integrate(nb, constants.G, hdt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)
        periods = accretion.orbital_periods(constants, nb, self.n_hydroframe) \
            if self.any_accretion else None

        # the derived values as the reference left them at the end of the
        # last step (:456): this step's starting fields and the bodies
        # before the drift. Kick 1's potential and the feedback smoothing
        # take their scale height, an accreting kick 1 its pressure too; a
        # locally isothermal H of AspectRatioMode 0 is the static profile,
        # which the kick derives itself
        bodies_prev = self.bodies_on_grid(nb_pre_drift, time)
        stale = self.derived(sigma, energy, bodies_prev) \
            if self._feedback_on() or phys.is_adiabatic \
            or self.any_accretion or phys.aspectratio_mode != 0 else None
        h0 = stale[2] if stale is not None else None
        # the disk force and indirect terms from the fields before the
        # accretion, applied to the bodies after it (:295-308)
        dax, day, it_disk = self._disk_feedback(
            sigma, h0, self.bodies_on_grid(nb, time))
        it_nb = self._indirect_nbody(nb_pre_drift, bodies_prev, hdt)
        if self.any_accretion:
            sig0, e0 = sigma, energy
            sigma, energy, nb = self._accrete(
                nb, sigma, energy, vrad, vaz, omega_frame, hdt,
                lambda: self.viscosity_grid(stale[0], stale[2], sig0, e0,
                                            bodies_prev), periods)
        if dax is not None:
            nb = nbody_sys.kick(nb, dax, day, hdt)
        nb = nbody_sys.kick(nb, it_disk[0] + it_nb[0], it_disk[1] + it_nb[1],
                            hdt)
        pot_it = self._pot_indirect(it_disk, it_nb)

        # the frame rotates by half a step (:289), its rate measured over
        # this half drift
        if phys.corotating:
            k = self._corotation_body()
            omega_frame, vaz = self._corotation_update(
                nb, vaz, omega_frame, hdt, nb_pre_drift.x[k],
                nb_pre_drift.y[k])
        nb = nbody_sys.rotate(nb, omega_frame * hdt)
        frame_angle = state.frame_angle + omega_frame * hdt

        # the dust, integrated in two halves against the gas of each half
        particles = state.particles
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, hdt,
                time)

        # gas kick 1/2, smoothed with h0 (:319); Disk: no runs none of the
        # gas, not even FLD (fargocpt_tpu/step.py:1018-1061)
        disk = phys.calculate_disk
        h_kick1 = nu_kick2 = None
        qplus, qminus = state.qplus, state.qminus
        sg_kernel, sor = state.sg_kernel, state.fld_sor
        if disk:
            (vrad, vaz, energy, _, _, sg_kernel, sor, h_kick1,
             nu_kick1, _) = self._gas_kick(
                sigma, vrad, vaz, energy, pot_it, time, hdt, omega_frame,
                self.bodies_on_grid(nb, time), sg_kernel, sor, stale_h=h0,
                stale_derived=stale if self.any_accretion else None)
            sigma, vrad, vaz, energy, _ = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, nu=nu_kick1, nb=nb,
                time=time)
            # gas drift 1/1
            sigma, vrad, vaz, energy, mass_flux = kernels.transport(
                self.ops, sigma, vrad, vaz, energy, omega_frame, dt)
            sigma = eos.apply_sigma_floor(phys, sigma)
            if phys.is_adiabatic:
                energy = eos.energy_floor_ceiling(phys, constants, sigma,
                                                  energy)

        # gas kick 2/2 with the bodies at x_{i+1/2}: its disk force and
        # indirect terms come first and reach the bodies after it; the
        # feedback and the potential smooth with kick 1's in-kick scale
        # height (the reference's SCALE_HEIGHT, last written by kick 1's
        # recalculate_viscosity at :328, read at :353 and :363)
        h_stale = h0 if h_kick1 is None else h_kick1
        bodies_mid = self.bodies_on_grid(nb, mid_time)
        dax, day, it_disk = self._disk_feedback(sigma, h_stale, bodies_mid)
        it_nb = self._indirect_nbody(nb, bodies_mid, hdt)
        pot_it = self._pot_indirect(it_disk, it_nb)
        if disk:
            (vrad, vaz, energy, qplus, qminus, sg_kernel, sor, _,
             nu_kick2, _) = self._gas_kick(sigma, vrad, vaz, energy, pot_it,
                                           mid_time, hdt, omega_frame,
                                           bodies_mid, sg_kernel, sor,
                                           stale_h=h_kick1)

        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, hdt,
                mid_time)

        # accretion's second half, viscous accretion on kick 2's in-kick
        # viscosity; then the stored disk and indirect kicks, N-body drift
        # 2/2 (:403-417) and the second half of the frame's rotation
        if self.any_accretion:
            sigma, energy, nb = self._accrete(
                nb, sigma, energy, vrad, vaz, omega_frame, hdt,
                lambda: nu_kick2 if nu_kick2 is not None
                else self._accretion_nu(sigma, energy, bodies_mid), periods)
        if dax is not None:
            nb = nbody_sys.kick(nb, dax, day, hdt)
        nb = nbody_sys.kick(nb, it_disk[0] + it_nb[0], it_disk[1] + it_nb[1],
                            hdt)
        nb_pre_drift = nb
        nb = nbody_sys.integrate(nb, constants.G, hdt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)
        if phys.corotating:
            k = self._corotation_body()
            omega_frame, vaz = self._corotation_update(
                nb, vaz, omega_frame, hdt, nb_pre_drift.x[k],
                nb_pre_drift.y[k])
        nb = nbody_sys.rotate(nb, omega_frame * hdt)
        frame_angle = frame_angle + omega_frame * hdt
        if phys.integrate_particles and particles is not None:
            particles = particles.replace(phi=torch.remainder(
                particles.phi - omega_frame * dt, 2.0 * math.pi))

        # the final boundary conditions, the damping zones first; the
        # leapfrog books no floor mass (fargocpt_tpu/step.py:1099-1112)
        monitor_acc = state.monitor_acc
        if disk:
            sigma, vrad, vaz, energy, dmp = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, nu=nu_kick2,
                final=True, dt=dt, nb=nb, time=time + dt)
            if phys.keep_mass_constant:
                sigma = self._rescale_to_initial_mass(sigma)
            monitor_acc = self._update_monitor_acc(
                self._mass_deltas(state, mass_flux, dmp), mass_flux, sigma,
                vrad, vaz, energy, nb, mid_time, pot_it, dt)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, monitor_acc=monitor_acc, fld_sor=sor,
            sg_kernel=sg_kernel, particles=particles)

    def _accrete(self, nb, sigma, energy, vrad, vaz, omega_frame, dt,
                 nu_grid, periods=None):
        """Accretion onto the bodies (``ops/accretion.py``), then the
        density floor. ``nu_grid`` is a callable that gives the viscosity
        grid the viscous variant reads, called only where a body takes it.
        Returns (sigma, energy, nb)."""
        cell_x, cell_y = self.cell_x, self.cell_y
        sigma, energy, nb = accretion.accrete_onto_planets(
            self.phys, self.constants, self.g, nb,
            self.body_accretion_efficiency, self.accretion_types, cell_x,
            cell_y, sigma, energy, vrad, vaz, omega_frame, dt,
            nu_grid=nu_grid() if "viscous" in self.accretion_types
            else None, periods=periods, row_w=self._own_act_col,
            comm=self.comm)
        return eos.apply_sigma_floor(self.phys, sigma), energy, nb

    def _corotation_body(self) -> int:
        """The body the corotating frame follows (indices past the last
        body take the last, as the JAX package's indexing clamps them)."""
        return min(self.phys.corotation_reference_body, self.n_bodies - 1)

    def _corotation_update(self, nb, vaz, omega_frame, dt, ref_x, ref_y):
        """The corotating frame's new rate, the reference body's angle
        swept from (``ref_x``, ``ref_y``) over ``dt``, and v_az corrected
        by the change (reference src/frame_of_reference.cpp:30-52
        ``handle_corotation``; fargocpt_tpu/step.py:1227-1252). The angle
        is atan2 of the cross and dot products, the reference's asin of
        the cross product over the distances for any angle under 90
        degrees. Returns (omega_frame, vaz), the rate a 0-d tensor of the
        field type."""
        k = self._corotation_body()
        x, y = nb.x[k], nb.y[k]
        cross = ref_x * y - x * ref_y
        dot = ref_x * x + ref_y * y
        omega_new = (torch.atan2(cross, dot) / dt).to(omega_frame.dtype)
        return omega_new, vaz - (omega_new - omega_frame) * self.g.rb

    def _disk_ecc_peri(self, sigma, vrad, vaz, omega_frame):
        """The disk's mass-averaged eccentricity and pericentre, at frame
        angle 0 (the in-step changes do not depend on it; reference
        src/quantities.cpp ``calculate_disk_delta_ecc_peri``)."""
        zero = torch.zeros((), dtype=sigma.dtype, device=sigma.device)
        return quant.disk_ecc_peri(
            self.phys, self.constants, self.g, sigma, vrad, vaz, omega_frame,
            zero, self.ops.cos_row[None, :], self.ops.sin_row[None, :],
            self.ecc_radius_limit, self._own_int_col, self.comm)

    def _ecc_delta(self, ecc: list, before, sigma, vrad, vaz, omega_frame):
        """Append the (e, peri) change since ``before`` to ``ecc``; returns
        the new (e, peri)."""
        now = self._disk_ecc_peri(sigma, vrad, vaz, omega_frame)
        ecc.append((now[0] - before[0], now[1] - before[1]))
        return now

    def _update_monitor_acc(self, acc: MonitorAccum, mass_flux, sigma, vrad,
                            vaz, energy, nb, time, pot_it,
                            dt) -> MonitorAccum:
        """Add the step's increments to the monitor grids that are on
        (reference src/quantities.cpp:976-998 + TransportEuler.cpp:610-616;
        fargocpt_tpu/step.py:1148-1195): the mass through each face, the
        advection, viscous and gravitational torques times dt (the last in
        the potential of the bodies ``nb`` at ``time`` with the indirect
        term ``pot_it``), alpha times dt. The writer divides and clears
        them."""
        phys, g = self.phys, self.g
        kw = {}
        if phys.write_alpha_grav_mean or phys.write_alpha_reynolds_mean:
            cs_a = self.derived(sigma, energy)[0]
        if phys.write_alpha_reynolds_mean:
            t_rey = quant.reynolds_stress(g, sigma, vrad, vaz)
            kw["alpha_reynolds_mean"] = acc.alpha_reynolds_mean \
                + quant.alpha_from_stress(t_rey, sigma, cs_a) * dt
        if phys.write_alpha_grav_mean:
            if self.selfgravity is not None:
                g_r, g_t = self._sg_accels(sigma)
                t_grav = quant.gravitational_stress(phys, self.constants, g,
                                                    g_r, g_t)
            else:
                t_grav = torch.zeros_like(sigma)
            kw["alpha_grav_mean"] = acc.alpha_grav_mean \
                + quant.alpha_from_stress(t_grav, sigma, cs_a) * dt
        if phys.write_massflow:
            # the outer face's flux goes to the last ring
            nr = g.nrad
            mf = acc.massflow + mass_flux[:nr]
            kw["massflow"] = torch.cat([mf[:nr - 1],
                                        mf[nr - 1:] + mass_flux[nr:]])
        if phys.write_gas_torques:
            cs, _, h = self.derived(sigma, energy)
            nu = self.viscosity_grid(cs, h)
            kw["t_adv"] = acc.t_adv + quant.advection_torque_increment(
                g, sigma, vrad, vaz, dt)
            kw["t_visc"] = acc.t_visc + quant.viscous_torque_increment(
                g, sigma, nu, vrad, vaz, dt)
            cell_x, cell_y = self.cell_x, self.cell_y
            pot = gravity.nbody_potential(
                phys, self.constants, g, self.bodies_on_grid(nb, time),
                self.n_bodies, cell_x, cell_y, h, pot_it[0], pot_it[1])
            kw["t_grav"] = acc.t_grav + quant.gravitational_torque_increment(
                g, sigma, pot, dt)
        return acc.replace(**kw) if kw else acc

    def cfl_dt(self, state: SystemState, time=0.0) -> torch.Tensor:
        """CFL time step as a 0-d tensor (reference src/cfl.cpp:185-382);
        a PVTE refresh warms from ``state.pvte_guess``. Under
        AspectRatioMode or AlphaMode it reads the grids of the bodies at
        ``time`` (a float or a 0-d tensor; fargocpt_tpu/step.py:1604-1611),
        and the viscosity always takes the fields' per-cell alpha."""
        f = state.fields
        phys = self.phys
        with self._pvte_scope(state.pvte_guess):
            if self.gates["cfl"]:
                dt = kernels.cfl(self.ops, f.sigma, f.vrad, f.vaz, f.energy,
                                 state.qplus, state.qminus)
            else:
                bodies = self.bodies_on_grid(state.nbody, time) \
                    if phys.aspectratio_mode in (1, 2) \
                    or phys.alpha_mode != 0 else None
                cs, _, h = self.derived(f.sigma, f.energy, bodies)
                nu = self.viscosity_grid(cs, h, f.sigma, f.energy, bodies)
                dt = cfl_ops.condition_cfl(
                    phys, self.g, f.sigma, f.vrad, f.vaz, f.energy, cs, nu,
                    state.qplus, state.qminus)
        # when sharded the least over the ranks, whose windows cover every
        # active ring (the reference's MPI_Allreduce MIN, src/cfl.cpp:379;
        # fargocpt_tpu/step.py:1600-1617)
        return self.comm.min(dt) if self.comm is not None else dt

    def advance_to(self, state: SystemState, time, last_dt, t_target,
                   max_steps: int | None = None, first_step: int = 0):
        """Advance to ``t_target`` with the reference's dt rules
        (src/simulation.cpp:505-560): dt = min(CFL_max_var * last_dt,
        cfl_dt), stretched or clamped to land on ``t_target``; ``last_dt``
        carries the unclamped dt. One host sync per step: the landing test.
        Each step's CFL and step share their PVTE memo. ``max_steps`` stops
        it after that many steps, short of ``t_target`` if need be (the
        command line's ``-N``). With ``debug_nans`` each step's state is
        checked for finiteness (one more read a step), ``first_step`` the
        number of the run's steps before this call.

        Returns (state, time, last_dt, n_steps, dt_min, dt_max, dt_sum,
        dt_sum_sq), the scalars as 0-d tensors except n_steps."""
        dev = state.fields.sigma.device
        as_t = lambda v: torch.as_tensor(v, dtype=self.dtype,  # noqa: E731
                                         device=dev).clone()
        time, last_dt, target = as_t(time), as_t(last_dt), as_t(t_target)
        dmin = as_t(torch.finfo(self.dtype).max)
        dmax, dsum, dsq = as_t(0.0), as_t(0.0), as_t(0.0)
        n = 0
        self._memo_shared = True
        try:
            while True:
                if self._halo_refresh is not None:
                    # a rank's halo rows from its neighbours, once a step
                    # before the CFL and the step (fargocpt_tpu/step.py:
                    # 1641-1646; the reference's CommunicateBoundaries)
                    state = self._halo_refresh(state)
                # Disk: no keeps last_dt and makes no CFL evaluation
                # (reference src/simulation.cpp:100-117)
                dt = torch.minimum(self.phys.cfl_max_var * last_dt,
                                   self.cfl_dt(state, time)) \
                    if self.phys.calculate_disk else last_dt
                time_left = target - time
                clamp = (dt > time_left) | (time_left < dt * 1.05)
                step_dt = torch.where(clamp, time_left, dt)
                state = self.step(state, time, step_dt)
                self._pv_memo.clear()
                time = torch.where(clamp, target, time + step_dt)
                last_dt = dt
                n += 1
                if self.debug_nans:
                    check_finite(state, first_step + n)
                dmin = torch.minimum(dmin, step_dt)
                dmax = torch.maximum(dmax, step_dt)
                dsum = dsum + step_dt
                dsq = dsq + step_dt * step_dt
                if bool(clamp) or (max_steps is not None
                                   and n >= max_steps):
                    return state, time, last_dt, n, dmin, dmax, dsum, dsq
        finally:
            self._memo_shared = False
            self._pv_memo.clear()

    # ------------------------------------------------------------------
    def initial_monitor_acc(self) -> MonitorAccum:
        """The mass bookkeeping, the monitor grids that are on and the
        Roche-lobe tracker's rate, zero (fargocpt_tpu/step.py:1196-1212)."""
        phys, g = self.phys, self.g

        def zeros(on, shape=(g.nrad, g.naz)):
            return torch.zeros(shape, dtype=self.dtype, device=self.device) \
                if on else None
        torques = phys.write_gas_torques
        return MonitorAccum(
            mass_delta=zeros(True, (N_MASS_DELTA,)),
            massflow=zeros(phys.write_massflow), t_adv=zeros(torques),
            t_visc=zeros(torques), t_grav=zeros(torques),
            alpha_grav_mean=zeros(phys.write_alpha_grav_mean),
            alpha_reynolds_mean=zeros(phys.write_alpha_reynolds_mean),
            decc=zeros(phys.write_ecc_changes, (N_ECC_STAGES,)),
            dperi=zeros(phys.write_ecc_changes, (N_ECC_STAGES,)),
            rof_mdot=zeros(phys.rochelobe_overflow, ()))

    def initial_system_state(self, fields: FieldState,
                             nbody: NBodyState) -> SystemState:
        """Assemble the run state; Q+/Q- seeded as at init (reference
        src/SourceEuler.cpp:1507-1547 ``compute_heating_cooling_for_CFL``)
        with the constant-gamma SubStep3, as the JAX package seeds them;
        a float32 PVTE run's warm-start cache from a cold refresh."""
        phys, constants, g = self.phys, self.constants, self.g
        sigma, energy = fields.sigma, fields.energy
        bodies = self.bodies_on_grid(nbody, 0.0)
        with self._pvte_scope(None):
            cs, _, h = self.derived(sigma, energy, bodies)
            pvte_guess = None
            if self.pvte is not None and self.pvte.fast:
                pvte_guess = self.pvte_vals(sigma, energy)[:2]
            nu = self.viscosity_grid(cs, h, sigma, energy, bodies) \
                if phys.is_adiabatic else None
        qplus = qminus = torch.zeros_like(sigma)
        if phys.is_adiabatic:
            trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
                phys, g, sigma, fields.vrad, fields.vaz, nu)
            _, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv,
                h, 0.0, 0.0, units=self.units,
                ref=(self.ref_sigma0, self.ref_energy0),
                irradiation_ctx=self.irradiation_ctx(bodies),
                aspect_grid=self.aspect_grid(cs, h, bodies)
                if phys.heating_star else None)
        k = self._corotation_body()
        omega0 = phys.omega_frame
        if phys.corotating and self.n_bodies > 1:
            # the frame starts with the reference body's angular velocity
            # (fargocpt_tpu/step.py:1738-1744)
            x, y, vx, vy = (float(v) for v in torch.stack(
                [nbody.x[k], nbody.y[k], nbody.vx[k], nbody.vy[k]]).tolist())
            omega0 = (x * vy - y * vx) / max(x * x + y * y, 1e-300)
        scalar = lambda v: torch.tensor(v, dtype=self.dtype,  # noqa: E731
                                        device=sigma.device)
        fld_sor = self.fld.initial_sor_state(self.dtype, self.device) \
            if self.fld is not None and self.fld.config.auto_omega else None
        sg_kernel = self.selfgravity.initial_kernel_state() \
            if self.selfgravity is not None and phys.is_adiabatic \
            and self.selfgravity.supports_in_run_update() else None
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=scalar(omega0), frame_angle=scalar(0.0),
            corot_ref_x=nbody.x[k].clone(), corot_ref_y=nbody.y[k].clone(),
            monitor_acc=self.initial_monitor_acc(), pvte_guess=pvte_guess,
            fld_sor=fld_sor, sg_kernel=sg_kernel)

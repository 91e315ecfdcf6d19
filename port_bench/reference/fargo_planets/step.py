"""The hydro step on the Euler integrator and the CFL time step
(reference src/simulation.cpp:148-274 ``step_Euler``, src/cfl.cpp), as far
as the benchmark's planet-disk configurations reach (``scope.py``).

The gas substeps take the decomposition the JAX package picks from the
configuration (``fargocpt_tpu/step.py:244-304``, ``gates`` below):

* constant gamma without surface cooling or irradiation: the fused ops,
  the potential + momentum sources, then the viscous kick (compression
  heating, artificial viscosity, viscosity, SubStep3), and the CFL;
* with surface cooling or irradiation: the fused sources and CFL, then the
  unfused composition: compression heating, the SN or TW artificial
  viscosity, the energy floor, viscosity, SubStep3 with its cooling and
  the stars' irradiation.

Then the boundary conditions and the FARGO transport; the damping zones
(``ops/damping.py``) act in the step's final boundary call only. The dust
swarm (``particles/dust.py``) is integrated against the step-start gas
fields, after the N-body kick and before the frame rotation. Every op is
its plain PyTorch version (``ops/kernels.py``), on any device.

Planets. The gas feels each body's ramped mass with its cubic smoothing
(``bodies_on_grid``), the bodies feel the disk (``_disk_feedback``) and
the frame's indirect terms, and drift under their mutual gravity by the
plain IAS15 (``nbody/ias15.py``), twice a step: the indirect term's
predictor and the drift. A body with a temperature irradiates the disk
(``HeatingStar``, in SubStep3 of the unfused substeps).

The time loop is a host loop with one host sync per step: the decision
whether the step lands on the output time.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .nbody.system import BodyConfig, NBodyState
from .ops import artvisc, boundary, cfl as cfl_ops, eos, gravity, \
    kernels, sources as src_ops, viscosity as visc_ops
from .ops import energy as energy_ops
from .ops.boundary import RefValues
from .ops.common import ring_col
from .ops.damping import DampingZones
from .params import Physics, ARTVISC_SN, ARTVISC_TW
from .particles import dust
from .state import (FieldState, MonitorAccum, SystemState, N_MASS_DELTA,
                    MD_DAMP_IN_CREATE, MD_FLOOR_CREATE, MD_INNER_IN,
                    MD_INNER_OUT, MD_OUTER_IN, MD_OUTER_OUT)


def gates(phys: Physics) -> dict[str, bool]:
    """Which fused op each substep takes: the JAX package's
    ``_fuse_sources``, ``_fuse_visc`` and ``_fuse_cfl``
    (fargocpt_tpu/step.py:244-304) without the TPU-only terms and the
    branches this copy refuses, and ``artvisc_sn``: the Stone-Norman
    substep of the unfused branch, which the JAX package runs as jnp
    there and the port as its kernel."""
    sources = not phys.is_polytropic and phys.aspectratio_mode == 0
    viscous_kick = (
        (phys.is_adiabatic or phys.is_isothermal)
        and phys.aspectratio_mode == 0 and phys.alpha_mode == 0
        and phys.stabilize_viscosity == 0
        and phys.artificial_viscosity in (ARTVISC_SN, ARTVISC_TW, "none")
        and not phys.heating_star and not phys.cooling_surface_enabled
        and not energy_ops.beta_or_scurve_cooling(phys)
        and not phys.cooling_beta_reference
        and not phys.write_ecc_changes)
    cfl = (not phys.is_polytropic and phys.alpha_mode == 0
           and phys.stabilize_viscosity != 2 and phys.aspectratio_mode == 0)
    return {"sources": sources, "viscous_kick": viscous_kick, "cfl": cfl,
            "artvisc_sn": (not viscous_kick
                           and phys.artificial_viscosity == ARTVISC_SN)}


def make_ref_values(fields: FieldState) -> RefValues:
    return RefValues(sigma0=fields.sigma, energy0=fields.energy,
                     vrad0=fields.vrad, vaz0=fields.vaz)


class HydroStep(nn.Module):
    """Step and CFL callables for one configuration. The geometry columns,
    the kernels' column table, the bodies' per-body columns, the damping
    columns and the reference values are buffers: ``.to(device)`` moves
    every one of them."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, *, dtype: torch.dtype,
                 device: torch.device | str,
                 units=None,
                 transport_route: str | None = None,
                 particle_params: dust.ParticleParams | None = None):
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
        # the cells' Cartesian centres, which the bodies' potential, their
        # pull and the irradiation read
        cell_x, cell_y = self.ops.cell_xy()
        self.register_buffer("cell_x", cell_x)
        self.register_buffer("cell_y", cell_y)
        # per-body ramp-up times (ramp-up periods x the period of the initial
        # orbit) and cubic smoothing factors, float64 as the bodies are
        # (fargocpt_tpu/step.py:156-161)
        periods = [2.0 * math.pi * math.sqrt(
            b.semi_major_axis ** 3 / (constants.G * phys.hydro_center_mass))
            if b.semi_major_axis > 0 else 0.0 for b in bodies]
        self.register_buffer("body_ramp_time", torch.tensor(
            [b.ramp_up_time for b in bodies], dtype=torch.float64,
            device=device) * torch.tensor(periods, dtype=torch.float64,
                                          device=device))
        self.register_buffer("body_cubic_factor", torch.tensor(
            [b.cubic_smoothing_factor for b in bodies], dtype=torch.float64,
            device=device))
        self.any_cubic = any(b.cubic_smoothing_factor != 0.0 for b in bodies)
        self.damping = DampingZones(phys, constants, geometry, dtype,
                                    device) if phys.damping else None
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            self.register_buffer(
                f"ref_{name}", getattr(ref_values, name).to(device, dtype))
        needs_units = phys.cooling_surface_enabled \
            or phys.integrate_particles or phys.heating_star
        if needs_units and units is None:
            raise ValueError("surface cooling, irradiation and the dust "
                             "need the run's units")
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
        # viscous v_rad boundary
        self.in_kick = (self.gates["viscous_kick"] and phys.is_adiabatic
                        and "viscous" in (phys.bc_vrad_inner,
                                          phys.bc_vrad_outer))
        self.particle_params = particle_params or dust.ParticleParams()
        self.dust_grid = dust.DustGrid(geometry, dtype, device) \
            if phys.integrate_particles else None
        # no PVTE in this copy (``scope.py``): the harness's check reads
        # ``pvte`` and ``pvte_vals``
        self.pvte = None
        self._active_rows = ring_col(self.g, 1)

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
    def pvte_vals(self, sigma, energy):
        """The PVTE grids of (sigma, energy): None, the copy has no PVTE."""
        return None

    def derived(self, sigma, energy):
        """Sound speed, pressure and scale height."""
        return kernels.derived(self.ops, sigma, energy)

    def viscosity_grid(self, cs, h):
        """The viscosity grid (reference src/viscosity/viscosity.cpp)."""
        return visc_ops.kinematic_viscosity(self.phys, self.g, cs, h)

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

    def ref_values(self) -> RefValues:
        return RefValues(sigma0=self.ref_sigma0, energy0=self.ref_energy0,
                         vrad0=self.ref_vrad0, vaz0=self.ref_vaz0)

    def _apply_bcs(self, sigma, vrad, vaz, energy, omega_frame, nu=None,
                   final: bool = False, dt=None):
        """The boundary conditions (fargocpt_tpu/step.py:518-599); on the
        final application of a step (``final``) the damping zones first,
        toward the initial state (``scope.py``). ``nu`` is the viscosity
        grid of the step's viscous substep, which the viscous v_rad BC
        reads (the reference's data[VISCOSITY]); without it the current
        fields' grid. Returns the fields and the (4,) damping mass deltas
        (zeros without damping)."""
        phys = self.phys
        dmp = torch.zeros(4, dtype=sigma.dtype, device=sigma.device)
        if final and self.damping is not None:
            sig_before = sigma
            sigma, vrad, vaz, energy = self.damping.apply(
                phys, sigma, vrad, vaz, energy, self.ref_values(), dt)
            if sigma is not sig_before:
                dmp = self.damping.mass_deltas(self.g, sig_before, sigma)
        if nu is None and "viscous" in (phys.bc_vrad_inner,
                                        phys.bc_vrad_outer):
            cs, _, h = self.derived(sigma, energy)
            nu = self.viscosity_grid(cs, h)
        fields = boundary.apply_boundary_conditions(
            phys, self.constants, self.g, sigma, vrad, vaz, energy,
            self.ref_values(), omega_frame, nu=nu)
        return (*fields, dmp)

    def apply_bcs(self, fields: FieldState) -> FieldState:
        """Standalone BC application (at init, reference
        src/init.cpp:337-341)."""
        omega = torch.tensor(self.phys.omega_frame, dtype=self.dtype,
                             device=fields.sigma.device)
        sigma, vrad, vaz, energy, _ = self._apply_bcs(
            fields.sigma, fields.vrad, fields.vaz, fields.energy, omega)
        return FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy)

    def _integrate_particles(self, sigma, vrad, vaz, energy, nb, particles,
                             omega_frame, dt, time):
        """Drag + gravity integration of the swarm against the given gas
        fields by the exponential midpoint integrator
        (fargocpt_tpu/step.py:1274-1304), in the bodies' potential."""
        phys, constants = self.phys, self.constants
        _, press, h0 = self.derived(sigma, energy)
        temp = eos.temperature(phys, constants, sigma, energy, press, None)
        rho_mid = sigma / (phys.density_factor * h0)
        return dust.integrate_expmid(
            phys, self.particle_params, constants, self.units,
            self.dust_grid, particles, rho_mid, temp, vrad, vaz,
            self.bodies_on_grid(nb, time), self.n_bodies, omega_frame, dt)

    def irradiation_ctx(self, bodies: gravity.BodiesOnGrid):
        """What SubStep3's stellar irradiation reads (the JAX package's
        ``irradiation_ctx``, fargocpt_tpu/step.py:621-627); None without
        an irradiating body."""
        if not self.phys.heating_star:
            return None
        return energy_ops.IrradiationCtx(
            bodies=bodies, radius=self.body_radius,
            temperature=self.body_temperature,
            irradiates=self.body_irradiates,
            rampup=self.body_irradiation_rampup, cell_x=self.cell_x,
            cell_y=self.cell_y)

    # ------------------------------------------------------------------
    def _substeps(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies):
        """Sources, artificial viscosity, viscosity and energy (the
        'kick'; fargocpt_tpu/step.py:662-829). Returns (vrad, vaz, energy,
        qplus, qminus, nu): nu the viscosity grid of the viscous substep
        (None after the fused viscous kick unless ``self.in_kick``)."""
        phys, constants, g, ops = self.phys, self.constants, self.g, self.ops
        fused = self.gates
        if fused["sources"]:
            vrad, vaz = kernels.sources(ops, sigma, vrad, vaz, energy, bodies,
                                        pot_it, omega_frame, dt)
            if not fused["viscous_kick"]:
                energy = src_ops.compression_heating(phys, g, energy, vrad,
                                                     vaz, dt)
        else:
            cs, press, h = self.derived(sigma, energy)
            pot = gravity.nbody_potential(phys, constants, g, bodies,
                                          self.n_bodies, self.cell_x,
                                          self.cell_y, h, pot_it[0],
                                          pot_it[1])
            vrad, vaz, energy = src_ops.update_with_sourceterms(
                phys, g, sigma, press, pot, vrad, vaz, energy,
                omega_frame.to(sigma.dtype), dt)

        if fused["viscous_kick"]:
            out = kernels.viscous_kick(ops, sigma, vrad, vaz, energy, dt,
                                       time, compress=fused["sources"],
                                       want_cs=self.in_kick)
            nu_kick = None
            if self.in_kick:
                # nu of the in-kick cs, by the ops of the unfused path's
                # ``derived`` and ``viscosity_grid``
                nu_kick = self.viscosity_grid(
                    out[5], eos.scale_height(phys, constants, g, out[5]))
            return (*out[:5], nu_kick)

        if fused["artvisc_sn"]:
            vrad, vaz, energy = kernels.artvisc_sn(ops, sigma, vrad, vaz,
                                                   energy, dt)
        else:
            vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
                phys, g, sigma, vrad, vaz, energy, dt)
        if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)

        # recalculate_viscosity (reference src/SourceEuler.cpp:205-223)
        cs, _, h = self.derived(sigma, energy)
        nu = self.viscosity_grid(cs, h)
        trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
            phys, g, sigma, vrad, vaz, nu)
        vrad, vaz = visc_ops.update_velocities_with_viscosity(
            phys, g, sigma, vrad, vaz, trr, tpp, trp, dt, nu=nu)

        qplus = qminus = torch.zeros_like(sigma)
        if phys.is_adiabatic:
            energy, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
                time, dt, units=self.units,
                ref=(self.ref_sigma0, self.ref_energy0),
                irradiation_ctx=self.irradiation_ctx(bodies))
        return vrad, vaz, energy, qplus, qminus, nu

    def _feedback_on(self) -> bool:
        """Whether the disk's force on the bodies is evaluated. On a lone
        star the disk's kick and the disk indirect term cancel and the
        frame is re-centred on it each step, so its force is evaluated only
        where the gas potential takes the disk indirect term
        (IndirectTermDiskOnDisk)."""
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
        dax, day = gravity.disk_on_body_accel(
            self.phys, self.constants, self.g, bodies, self.n_bodies,
            self.cell_x, self.cell_y, h, sigma)
        return dax, day, gravity.indirect_term_disk(bodies, self.n_hydroframe,
                                                    dax, day)

    def _indirect_nbody(self, nb: NBodyState, dt):
        """The N-body indirect term (reference src/simulation.cpp:160-166):
        ``nb`` integrated ahead by ``dt`` with IAS15 (IndirectTermMode 0;
        the Euler sum of mode 1 is not in this copy)."""
        return gravity.indirect_term_nbody_predictor(
            self.constants, nb, self.n_hydroframe, self.n_bodies, dt)

    def _pot_indirect(self, it_disk, it_nb):
        """The indirect term of the gas potential (reference :168-176)."""
        if self.phys.indirect_term_disk_on_disk:
            return it_disk[0] + it_nb[0], it_disk[1] + it_nb[1]
        return it_nb

    def _mass_deltas(self, state: SystemState, mass_flux, dmp,
                     floor_created):
        """The step's boundary, damping and floor mass bookkeeping added to
        the run's (reference src/TransportEuler.cpp:575-608 +
        src/types.h:30-60)."""
        f_in, f_out = mass_flux[1], mass_flux[self.g.nrad - 1]
        like = mass_flux
        inc = [torch.zeros((), dtype=like.dtype, device=like.device)] \
            * N_MASS_DELTA
        inc[MD_INNER_IN] = torch.sum(torch.clamp(f_in, min=0.0))
        inc[MD_INNER_OUT] = torch.sum(torch.clamp(-f_in, min=0.0))
        inc[MD_OUTER_IN] = torch.sum(torch.clamp(-f_out, min=0.0))
        inc[MD_OUTER_OUT] = torch.sum(torch.clamp(f_out, min=0.0))
        inc[MD_DAMP_IN_CREATE:MD_DAMP_IN_CREATE + 4] = list(dmp)
        inc[MD_FLOOR_CREATE] = floor_created
        return state.monitor_acc.replace(
            mass_delta=state.monitor_acc.mass_delta + torch.stack(inc))

    def step(self, state: SystemState, time, dt) -> SystemState:
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

        # disk feedback on the bodies (reference :154-158), then the N-body
        # indirect term of the kicked bodies (:160-166)
        h0 = None
        if self._feedback_on():
            h0 = self.derived(sigma, energy)[2]
        dax, day, it_disk = self._disk_feedback(sigma, h0, bodies)
        if dax is not None:
            nb = nbody_sys.kick(nb, dax, day, dt)
        it_nb = self._indirect_nbody(nb, dt)
        nb = nbody_sys.kick(nb, it_disk[0] + it_nb[0], it_disk[1] + it_nb[1],
                            dt)
        pot_it = self._pot_indirect(it_disk, it_nb)

        # dust particles (reference :178-182 particles::integrate)
        particles = state.particles
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt,
                time)

        # the frame rotates at OmegaFrame (reference :186); the bodies and
        # the particles rotate with it
        if phys.integrate_particles and particles is not None:
            particles = particles.replace(phi=torch.remainder(
                particles.phi - omega_frame * dt, 2.0 * math.pi))
        nb = nbody_sys.rotate(nb, omega_frame * dt)
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps
        vrad, vaz, energy, qplus, qminus, nu_step = self._substeps(
            sigma, vrad, vaz, energy, pot_it, time, dt, omega_frame, bodies)

        # the viscous BC reads the in-kick viscosity grid (reference
        # data[VISCOSITY] from recalculate_viscosity, :196)
        sigma, vrad, vaz, energy, _ = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step)
        sigma, vrad, vaz, energy, mass_flux = kernels.transport(
            self.ops, sigma, vrad, vaz, energy, omega_frame, dt)
        sig_pre_floor = sigma
        sigma = eos.apply_sigma_floor(phys, sigma)
        floor_created = torch.sum((sigma - sig_pre_floor) * g.surf
                                  * self._active_rows)
        if phys.is_adiabatic:
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)

        # --- N-body drift (reference :218-221) ---
        nb = nbody_sys.integrate(nb, constants.G, dt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)

        # the final boundary conditions, the damping zones first
        sigma, vrad, vaz, energy, dmp = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step, final=True,
            dt=dt)
        monitor_acc = self._mass_deltas(state, mass_flux, dmp, floor_created)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, monitor_acc=monitor_acc,
            particles=particles)

    def cfl_dt(self, state: SystemState, time=0.0) -> torch.Tensor:
        """CFL time step as a 0-d tensor (reference src/cfl.cpp:185-382)."""
        f = state.fields
        if self.gates["cfl"]:
            return kernels.cfl(self.ops, f.sigma, f.vrad, f.vaz, f.energy,
                               state.qplus, state.qminus)
        cs, _, h = self.derived(f.sigma, f.energy)
        nu = self.viscosity_grid(cs, h)
        return cfl_ops.condition_cfl(
            self.phys, self.g, f.sigma, f.vrad, f.vaz, f.energy, cs, nu,
            state.qplus, state.qminus)

    def advance_to(self, state: SystemState, time, last_dt, t_target,
                   max_steps: int | None = None, first_step: int = 0):
        """Advance to ``t_target`` with the reference's dt rules
        (src/simulation.cpp:505-560): dt = min(CFL_max_var * last_dt,
        cfl_dt), stretched or clamped to land on ``t_target``; ``last_dt``
        carries the unclamped dt. One host sync per step: the landing test.
        ``max_steps`` stops it after that many steps, short of ``t_target``
        if need be (the command line's ``-N``). ``first_step``, the number
        of the run's steps before this call, is the port's argument and
        unused here.

        Returns (state, time, last_dt, n_steps, dt_min, dt_max, dt_sum,
        dt_sum_sq), the scalars as 0-d tensors except n_steps."""
        dev = state.fields.sigma.device
        as_t = lambda v: torch.as_tensor(v, dtype=self.dtype,  # noqa: E731
                                         device=dev).clone()
        time, last_dt, target = as_t(time), as_t(last_dt), as_t(t_target)
        dmin = as_t(torch.finfo(self.dtype).max)
        dmax, dsum, dsq = as_t(0.0), as_t(0.0), as_t(0.0)
        n = 0
        while True:
            dt = torch.minimum(self.phys.cfl_max_var * last_dt,
                               self.cfl_dt(state, time))
            time_left = target - time
            clamp = (dt > time_left) | (time_left < dt * 1.05)
            step_dt = torch.where(clamp, time_left, dt)
            state = self.step(state, time, step_dt)
            time = torch.where(clamp, target, time + step_dt)
            last_dt = dt
            n += 1
            dmin = torch.minimum(dmin, step_dt)
            dmax = torch.maximum(dmax, step_dt)
            dsum = dsum + step_dt
            dsq = dsq + step_dt * step_dt
            if bool(clamp) or (max_steps is not None and n >= max_steps):
                return state, time, last_dt, n, dmin, dmax, dsum, dsq

    # ------------------------------------------------------------------
    def initial_monitor_acc(self) -> MonitorAccum:
        """The mass bookkeeping, zero; the monitor grids and the Roche-lobe
        tracker are off in this copy (``scope.py``)."""
        return MonitorAccum(mass_delta=torch.zeros(
            (N_MASS_DELTA,), dtype=self.dtype, device=self.device))

    def initial_system_state(self, fields: FieldState,
                             nbody: NBodyState) -> SystemState:
        """Assemble the run state; Q+/Q- seeded as at init (reference
        src/SourceEuler.cpp:1507-1547 ``compute_heating_cooling_for_CFL``)
        with the constant-gamma SubStep3, as the JAX package seeds them."""
        phys, constants, g = self.phys, self.constants, self.g
        sigma, energy = fields.sigma, fields.energy
        bodies = self.bodies_on_grid(nbody, 0.0)
        cs, _, h = self.derived(sigma, energy)
        qplus = qminus = torch.zeros_like(sigma)
        if phys.is_adiabatic:
            nu = self.viscosity_grid(cs, h)
            trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
                phys, g, sigma, fields.vrad, fields.vaz, nu)
            _, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv,
                h, 0.0, 0.0, units=self.units,
                ref=(self.ref_sigma0, self.ref_energy0),
                irradiation_ctx=self.irradiation_ctx(bodies))
        scalar = lambda v: torch.tensor(v, dtype=self.dtype,  # noqa: E731
                                        device=sigma.device)
        k = min(self.phys.corotation_reference_body, self.n_bodies - 1)
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=scalar(phys.omega_frame), frame_angle=scalar(0.0),
            corot_ref_x=nbody.x[k].clone(), corot_ref_y=nbody.y[k].clone(),
            monitor_acc=self.initial_monitor_acc())

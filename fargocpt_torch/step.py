"""The Euler hydro step and the CFL time step (reference
src/simulation.cpp:148-274 ``step_Euler``, src/cfl.cpp).

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

Self-gravity kicks the gas first; FLD radiative diffusion follows the
substeps. Then the boundary conditions and the FARGO transport, whose
route is fixed when the ``HydroStep`` is built (``ops/transport.route``,
or the ``transport_route`` the caller names). The dust swarm
(``particles/dust.py``) is integrated against the step-start gas fields,
after the N-body kick and before the frame rotation.
The ops dispatch on the tensors' device (``ops/kernels.py``): the plain
PyTorch versions on the CPU, the CUDA kernels on a GPU.

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
from .ops import artvisc, boundary, cfl as cfl_ops, eos, gravity, kernels, \
    sources as src_ops, viscosity as visc_ops
from .ops import energy as energy_ops
from .ops.boundary import RefValues
from .ops.fld import FLDConfig, FLDSolver
from .ops.pvte import PVTE
from .ops.selfgravity import SMOOTHING_MODES, SelfGravity
from .params import Physics, LEAPFROG, ARTVISC_SN, ARTVISC_TW
from .particles import dust
from .state import (FieldState, MonitorAccum, SystemState, N_MASS_DELTA,
                    MD_FLOOR_CREATE, MD_INNER_IN, MD_INNER_OUT, MD_OUTER_IN,
                    MD_OUTER_OUT)


def check_supported(phys: Physics, bodies: list[BodyConfig],
                    particle_params: dust.ParticleParams | None = None
                    ) -> None:
    """Raise NotImplementedError for every feature outside the ported
    slice, naming it."""
    unsupported = {
        "EquationOfState other than Ideal (adiabatic) or PVTE":
            not phys.is_adiabatic,
        "the PVTE lookup table (PVTELookupTable)":
            phys.variable_gamma and phys.pvte_lookup_table,
        "self-gravity in SelfGravityMode besselkernel (Bessel-kernel "
        "self-gravity)": phys.self_gravity
            and phys.self_gravity_mode not in SMOOTHING_MODES,
        "dust diffusion (ParticleDustDiffusion)":
            phys.integrate_particles and particle_params is not None
            and particle_params.diffusion,
        "planets (more than one N-body body)": len(bodies) > 1,
        "the leapfrog integrator": phys.hydro_integrator == LEAPFROG,
        "damping zones": phys.damping,
        "AspectRatioMode != 0": phys.aspectratio_mode != 0,
        "AlphaMode != 0": phys.alpha_mode != 0,
        "StabilizeViscosity": phys.stabilize_viscosity != 0,
        "Disk: no": not phys.calculate_disk,
        "KeepDiskMassConstant": phys.keep_mass_constant,
        "the corotating frame": phys.corotating,
        "Roche-lobe overflow": phys.rochelobe_overflow,
        "the MassFlow monitor grid": phys.write_massflow,
        "the gas-torque monitor grids": phys.write_gas_torques,
        "the alpha monitor grids": (phys.write_alpha_grav_mean
                                    or phys.write_alpha_reynolds_mean),
        "the eccentricity-change monitor": phys.write_ecc_changes,
        "the binary quadrupole support": phys.vaz_quadrupole_support,
        "accretion onto planets": any(b.accretion_type != "none"
                                      for b in bodies),
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")
    boundary.check_supported(phys)
    energy_ops.check_supported(phys)


def gates(phys: Physics) -> dict[str, bool]:
    """Which fused op each substep takes: the JAX package's
    ``_fuse_sources``, ``_fuse_visc`` and ``_fuse_cfl``
    (fargocpt_tpu/step.py:244-304) without the TPU-only terms, and
    ``artvisc_sn``: the Stone-Norman substep of the unfused branch, which
    the JAX package runs as jnp there and the port as its kernel."""
    bessel = phys.self_gravity and phys.self_gravity_mode == "besselkernel"
    sources = (not phys.variable_gamma and not phys.is_polytropic
               and phys.aspectratio_mode == 0 and not bessel)
    viscous_kick = (
        (phys.is_adiabatic or phys.is_isothermal)
        and not phys.variable_gamma
        and phys.aspectratio_mode == 0 and phys.alpha_mode == 0
        and phys.stabilize_viscosity == 0
        and phys.artificial_viscosity in (ARTVISC_SN, ARTVISC_TW, "none")
        and not phys.heating_star and not phys.cooling_surface_enabled
        and not phys.cooling_scurve_enabled
        and phys.cooling_beta_method == "no"
        and not phys.cooling_beta_reference
        and not phys.cooling_beta_model and not phys.cooling_beta_floor
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
    self-gravity solvers hold their tensors on ``device`` from the start."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, *, dtype: torch.dtype,
                 device: torch.device | str, units=None,
                 transport_route: str | None = None,
                 particle_params: dust.ParticleParams | None = None):
        super().__init__()
        bodies = bodies if bodies is not None else \
            [BodyConfig(name="DefaultStar", mass=phys.hydro_center_mass)]
        check_supported(phys, bodies, particle_params)
        self.phys = phys
        self.constants = constants
        self.units = units
        self.dtype = dtype
        self.n_bodies = len(bodies)
        self.n_hydroframe = n_hydroframe
        self.gates = gates(phys)
        self.ops = kernels.KernelContext(phys, constants, geometry, dtype,
                                         device, transport_route)
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            self.register_buffer(
                f"ref_{name}", getattr(ref_values, name).to(device, dtype))
        needs_units = phys.variable_gamma or phys.cooling_surface_enabled \
            or phys.radiative_diffusion or phys.integrate_particles
        if needs_units and units is None:
            raise ValueError("PVTE, surface cooling, FLD and the dust need "
                             "the run's units")
        self.particle_params = particle_params or dust.ParticleParams()
        self.dust_grid = dust.DustGrid(geometry, dtype, device) \
            if phys.integrate_particles else None
        self.pvte = PVTE(phys, units, dtype, device) \
            if phys.variable_gamma else None
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
        self.selfgravity = SelfGravity(phys, constants, geometry, dtype,
                                       device) if phys.self_gravity else None
        self._pv_memo: list = []
        self._pv_chain = None
        self._memo_shared = False

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

    def derived(self, sigma, energy, pv=None):
        """Sound speed, pressure and scale height; ``pv`` are stale PVTE
        grids to use instead of a refresh."""
        if pv is None:
            pv = self.pvte_vals(sigma, energy)
        return kernels.derived(self.ops, sigma, energy, pv)

    def viscosity_grid(self, cs, h):
        return visc_ops.kinematic_viscosity(self.phys, self.g, cs, h)

    def bodies_on_grid(self, nb: NBodyState) -> gravity.BodiesOnGrid:
        """Body data the gas-side ops need. A lone star has no orbit to
        ramp its mass over, and no Roche lobe: its Klahr cubic smoothing
        radius is zero."""
        return gravity.BodiesOnGrid(x=nb.x, y=nb.y, mass=nb.mass,
                                    cubic_smoothing_radius=torch.zeros_like(
                                        nb.x))

    def disk_torques(self, state: SystemState) -> torch.Tensor:
        """Torque of the gas disk on each body, m_k (x_k a_y - y_k a_x)
        (reference src/output.cpp ``write_torques`` path via
        ComputeDiskOnNbodyAccel); call it inside ``detached``."""
        f, nb = state.fields, state.nbody
        _, _, h = self.derived(f.sigma, f.energy)
        cell_x, cell_y = self.ops.cell_xy()
        ax, ay = gravity.disk_on_body_accel(
            self.phys, self.constants, self.g, self.bodies_on_grid(nb),
            self.n_bodies, cell_x, cell_y, h, f.sigma)
        return nb.mass * (nb.x * ay.to(nb.x.dtype) - nb.y * ax.to(nb.x.dtype))

    def _apply_bcs(self, sigma, vrad, vaz, energy, omega_frame):
        return boundary.apply_boundary_conditions(
            self.phys, self.constants, self.g, sigma, vrad, vaz, energy,
            omega_frame)

    def apply_bcs(self, fields: FieldState) -> FieldState:
        """Standalone BC application (at init, reference src/init.cpp:337-341)."""
        omega = torch.tensor(self.phys.omega_frame, dtype=self.dtype,
                             device=fields.sigma.device)
        sigma, vrad, vaz, energy = self._apply_bcs(
            fields.sigma, fields.vrad, fields.vaz, fields.energy, omega)
        return FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy)

    def _integrate_particles(self, sigma, vrad, vaz, energy, nb, particles,
                             omega_frame, dt):
        """Drag + gravity integration of the swarm against the given gas
        fields (fargocpt_tpu/step.py:1274-1304). The temperature is the one
        the reference's particles sample (per-cell gamma and mu with PVTE):
        for the step-start fields the PVTE grids come from the memo, with
        no refresh of their own."""
        phys, constants = self.phys, self.constants
        pp = self.particle_params
        _, press, h0 = self.derived(sigma, energy)
        temp = eos.temperature(phys, constants, sigma, energy, press,
                               self.pvte_vals(sigma, energy))
        rho_mid = sigma / (phys.density_factor * h0)
        integ = dust.integrate_rk45 if pp.integrator.startswith(
            ("e", "a", "r")) else dust.integrate_expmid
        sg_accel = None
        if pp.disk_gravity and self.selfgravity is not None:
            sg_accel = self.selfgravity.accelerations(sigma)
        return integ(phys, pp, constants, self.units, self.dust_grid,
                     particles, rho_mid, temp, vrad, vaz,
                     self.bodies_on_grid(nb), self.n_bodies, omega_frame, dt,
                     sg_accel=sg_accel)

    # ------------------------------------------------------------------
    def _substeps(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies, sg_kernel):
        """Self-gravity, sources, viscosity and energy (the 'kick';
        fargocpt_tpu/step.py:662-829). Returns (vrad, vaz, energy, qplus,
        qminus, sg_kernel, pv_last), pv_last the PVTE grids of SubStep3."""
        phys, constants, g, ops = self.phys, self.constants, self.g, self.ops
        fused = self.gates
        pv = self.pvte_vals(sigma, energy)
        if self.selfgravity is not None or not fused["sources"]:
            cs, press, h = self.derived(sigma, energy, pv)

        # self-gravity kick first (reference src/SourceEuler.cpp:438-441)
        if self.selfgravity is not None:
            spectra = None
            if sg_kernel is not None:
                sg_kernel = self.selfgravity.update_kernel(sg_kernel, sigma,
                                                           h, g)
                spectra = sg_kernel[:2]
            g_r, g_t = self.selfgravity.accelerations(sigma, spectra)
            vrad, vaz = self.selfgravity.kick(g, vrad, vaz, g_r, g_t, dt)

        if fused["sources"]:
            vrad, vaz = kernels.sources(ops, sigma, vrad, vaz, energy, bodies,
                                        pot_it, omega_frame, dt)
            if not fused["viscous_kick"]:
                energy = src_ops.compression_heating(phys, g, energy, vrad,
                                                     vaz, dt)
        else:
            cell_x, cell_y = ops.cell_xy()
            pot = gravity.nbody_potential(phys, constants, g, bodies,
                                          self.n_bodies, cell_x, cell_y, h,
                                          pot_it[0], pot_it[1])
            vrad, vaz, energy = src_ops.update_with_sourceterms(
                phys, g, sigma, press, pot, vrad, vaz, energy,
                omega_frame.to(sigma.dtype), dt, pvte_vals=pv)

        if fused["viscous_kick"]:
            vrad, vaz, energy, qplus, qminus = kernels.viscous_kick(
                ops, sigma, vrad, vaz, energy, dt, time,
                compress=fused["sources"])
            return vrad, vaz, energy, qplus, qminus, sg_kernel, None

        if fused["artvisc_sn"]:
            vrad, vaz, energy = kernels.artvisc_sn(ops, sigma, vrad, vaz,
                                                   energy, dt)
        else:
            vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
                phys, g, sigma, vrad, vaz, energy, dt)
        if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
            # the step-start PVTE grids, as the reference's floor reads
            # pvte::get_* of the last compute_gamma_mu
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                              pv)

        # recalculate_viscosity (reference src/SourceEuler.cpp:205-223)
        cs, _, h = self.derived(sigma, energy)
        nu = self.viscosity_grid(cs, h)
        trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
            phys, g, sigma, vrad, vaz, nu)
        vrad, vaz = visc_ops.update_velocities_with_viscosity(
            phys, g, sigma, vrad, vaz, trr, tpp, trp, dt)

        qplus = qminus = torch.zeros_like(sigma)
        pv3 = None
        if phys.is_adiabatic:
            pv3 = self.pvte_vals(sigma, energy)
            energy, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
                time, dt, units=self.units, pvte_vals=pv3)
        return vrad, vaz, energy, qplus, qminus, sg_kernel, pv3

    def step(self, state: SystemState, time, dt) -> SystemState:
        """One Euler step. The PVTE chain starts at ``state.pvte_guess``
        and its last link is carried to the next step."""
        with self._pvte_scope(state.pvte_guess):
            new_state = self._step_euler(state, time, dt)
            if state.pvte_guess is not None and self._pv_chain is not None:
                new_state = new_state.replace(pvte_guess=self._pv_chain)
        return new_state

    def _step_euler(self, state: SystemState, time, dt) -> SystemState:
        """One Euler step (reference src/simulation.cpp:148-274). ``dt`` and
        ``time`` may be 0-d device tensors."""
        phys, constants, g = self.phys, self.constants, self.g
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        dt = torch.as_tensor(dt, dtype=self.dtype, device=sigma.device)
        nb = state.nbody
        omega_frame = state.omega_frame
        bodies = self.bodies_on_grid(nb)

        # indirect terms (reference :154-176). With a lone star the disk's
        # kick on it and the disk indirect term cancel, so the disk force
        # is evaluated only where the gas potential takes the disk
        # indirect term (IndirectTermDiskOnDisk, on with self-gravity).
        if phys.indirect_term_mode == 0:
            it_nb = gravity.indirect_term_nbody_predictor(
                constants, nb, self.n_hydroframe, self.n_bodies, dt)
        else:
            it_nb = gravity.indirect_term_nbody(
                constants, bodies, self.n_hydroframe, self.n_bodies)
        it_x, it_y = it_nb
        if phys.indirect_term_disk_on_disk and phys.disk_feedback:
            _, _, h0 = self.derived(sigma, energy)
            cell_x, cell_y = self.ops.cell_xy()
            dax, day = gravity.disk_on_body_accel(
                phys, constants, g, bodies, self.n_bodies, cell_x, cell_y,
                h0, sigma)
            nb = nbody_sys.kick(nb, dax, day, dt)
            it_dx, it_dy = gravity.indirect_term_disk(
                bodies, self.n_hydroframe, dax, day)
            it_x, it_y = it_dx + it_nb[0], it_dy + it_nb[1]
        nb = nbody_sys.kick(nb, it_x, it_y, dt)
        pot_it = (it_x, it_y) if phys.indirect_term_disk_on_disk else it_nb

        # dust particles (reference :178-182 particles::integrate), which
        # then rotate with the frame (reference particles::rotate)
        particles = state.particles
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt)
            particles = particles.replace(phi=torch.remainder(
                particles.phi - omega_frame * dt, 2.0 * math.pi))

        nb = nbody_sys.rotate(nb, omega_frame * dt)
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps ---
        vrad, vaz, energy, qplus, qminus, sg_kernel, pv_last = self._substeps(
            sigma, vrad, vaz, energy, pot_it, time, dt, omega_frame, bodies,
            state.sg_kernel)

        # FLD radiative diffusion on the stale PVTE grids of SubStep3
        # (reference fld.cpp:996-1000 reads pvte::get_* with no refresh)
        sor = state.fld_sor
        if self.fld is not None:
            _, _, h_now = self.derived(sigma, energy, pv_last)
            energy, _, sor = self.fld.radiative_diffusion(
                g, sigma, energy, h_now, dt, sor_state=sor)
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                              pv_last)

        sigma, vrad, vaz, energy = self._apply_bcs(sigma, vrad, vaz, energy,
                                                   omega_frame)
        sigma, vrad, vaz, energy, mass_flux = kernels.transport(
            self.ops, sigma, vrad, vaz, energy, omega_frame, dt)
        sig_pre_floor = sigma
        sigma = eos.apply_sigma_floor(phys, sigma)
        floor_created = torch.sum(
            ((sigma - sig_pre_floor) * g.surf)[1:g.nrad - 1])
        energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)

        # --- N-body drift (reference :218-221) ---
        nb = nbody_sys.integrate(nb, constants.G, dt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)

        sigma, vrad, vaz, energy = self._apply_bcs(sigma, vrad, vaz, energy,
                                                   omega_frame)

        # boundary / floor mass bookkeeping (reference
        # src/TransportEuler.cpp:575-608 + src/types.h:30-60); no damping
        f_in, f_out = mass_flux[1], mass_flux[g.nrad - 1]
        inc = [torch.zeros((), dtype=sigma.dtype, device=sigma.device)] \
            * N_MASS_DELTA
        inc[MD_INNER_IN] = torch.sum(torch.clamp(f_in, min=0.0))
        inc[MD_INNER_OUT] = torch.sum(torch.clamp(-f_in, min=0.0))
        inc[MD_OUTER_IN] = torch.sum(torch.clamp(-f_out, min=0.0))
        inc[MD_OUTER_OUT] = torch.sum(torch.clamp(f_out, min=0.0))
        inc[MD_FLOOR_CREATE] = floor_created
        monitor_acc = state.monitor_acc.replace(
            mass_delta=state.monitor_acc.mass_delta + torch.stack(inc))

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, frame_angle=frame_angle,
            monitor_acc=monitor_acc, fld_sor=sor, sg_kernel=sg_kernel,
            particles=particles)

    def cfl_dt(self, state: SystemState) -> torch.Tensor:
        """CFL time step as a 0-d tensor (reference src/cfl.cpp:185-382);
        a PVTE refresh warms from ``state.pvte_guess``."""
        f = state.fields
        with self._pvte_scope(state.pvte_guess):
            if self.gates["cfl"]:
                return kernels.cfl(self.ops, f.sigma, f.vrad, f.vaz,
                                   f.energy, state.qplus, state.qminus)
            cs, _, h = self.derived(f.sigma, f.energy)
            return cfl_ops.condition_cfl(
                self.phys, self.g, f.sigma, f.vrad, f.vaz, f.energy, cs,
                self.viscosity_grid(cs, h), state.qplus, state.qminus)

    def advance_to(self, state: SystemState, time, last_dt, t_target,
                   max_steps: int | None = None):
        """Advance to ``t_target`` with the reference's dt rules
        (src/simulation.cpp:505-560): dt = min(CFL_max_var * last_dt,
        cfl_dt), stretched or clamped to land on ``t_target``; ``last_dt``
        carries the unclamped dt. One host sync per step: the landing test.
        Each step's CFL and step share their PVTE memo. ``max_steps`` stops
        it after that many steps, short of ``t_target`` if need be (the
        command line's ``-N``).

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
                dt = torch.minimum(self.phys.cfl_max_var * last_dt,
                                   self.cfl_dt(state))
                time_left = target - time
                clamp = (dt > time_left) | (time_left < dt * 1.05)
                step_dt = torch.where(clamp, time_left, dt)
                state = self.step(state, time, step_dt)
                self._pv_memo.clear()
                time = torch.where(clamp, target, time + step_dt)
                last_dt = dt
                n += 1
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
        return MonitorAccum(mass_delta=torch.zeros(
            N_MASS_DELTA, dtype=self.dtype, device=self.device))

    def initial_system_state(self, fields: FieldState,
                             nbody: NBodyState) -> SystemState:
        """Assemble the run state; Q+/Q- seeded as at init (reference
        src/SourceEuler.cpp:1507-1547 ``compute_heating_cooling_for_CFL``)
        with the constant-gamma SubStep3, as the JAX package seeds them;
        a float32 PVTE run's warm-start cache from a cold refresh."""
        phys, constants, g = self.phys, self.constants, self.g
        sigma, energy = fields.sigma, fields.energy
        with self._pvte_scope(None):
            cs, _, h = self.derived(sigma, energy)
            pvte_guess = None
            if self.pvte is not None and self.pvte.fast:
                pvte_guess = self.pvte_vals(sigma, energy)[:2]
        nu = self.viscosity_grid(cs, h)
        trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
            phys, g, sigma, fields.vrad, fields.vaz, nu)
        _, qplus, qminus = energy_ops.substep3(
            phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
            0.0, 0.0, units=self.units)
        k = min(phys.corotation_reference_body, self.n_bodies - 1)
        scalar = lambda v: torch.tensor(v, dtype=self.dtype,  # noqa: E731
                                        device=sigma.device)
        fld_sor = self.fld.initial_sor_state(self.dtype, self.device) \
            if self.fld is not None and self.fld.config.auto_omega else None
        sg_kernel = self.selfgravity.initial_kernel_state() \
            if self.selfgravity is not None and phys.is_adiabatic else None
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=scalar(phys.omega_frame), frame_angle=scalar(0.0),
            corot_ref_x=nbody.x[k].clone(), corot_ref_y=nbody.y[k].clone(),
            monitor_acc=self.initial_monitor_acc(), pvte_guess=pvte_guess,
            fld_sor=fld_sor, sg_kernel=sg_kernel)

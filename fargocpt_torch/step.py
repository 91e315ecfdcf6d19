"""The Euler hydro step and the CFL time step of the flagship configuration
(reference src/simulation.cpp:148-274 ``step_Euler``, src/cfl.cpp).

The gas substeps always take the fused decomposition of the JAX package's
production path: the potential + momentum sources without compression
heating, then the viscous kick (compression heating, artificial
viscosity, viscosity, SubStep3), the boundary conditions, and the FARGO
transport. The transport takes the route of the grid, fixed when the
``HydroStep`` is built (``ops/transport.route``): the whole-transport op
when NR is a multiple of 16, else the split route's two ops. The ops
dispatch on the tensors' device (``ops/kernels.py``): the plain PyTorch
versions on the CPU, the CUDA kernels on a GPU.

The time loop is a host loop with one host sync per step: the decision
whether the step lands on the output time.
"""

from __future__ import annotations

import torch
from torch import nn

from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .nbody.system import BodyConfig, NBodyState
from .ops import boundary, eos, gravity, kernels, viscosity as visc_ops
from .ops import energy as energy_ops
from .ops.boundary import RefValues
from .params import Physics, LEAPFROG
from .state import (FieldState, MonitorAccum, SystemState, N_MASS_DELTA,
                    MD_FLOOR_CREATE, MD_INNER_IN, MD_INNER_OUT, MD_OUTER_IN,
                    MD_OUTER_OUT)


def check_supported(phys: Physics, bodies: list[BodyConfig]) -> None:
    """Raise NotImplementedError for every feature outside the ported
    slice, naming it."""
    unsupported = {
        "EquationOfState other than Ideal (adiabatic)": not phys.is_adiabatic,
        "PVTE equation of state": phys.variable_gamma,
        "FLD radiative diffusion": phys.radiative_diffusion,
        "self-gravity": phys.self_gravity,
        "dust particles": phys.integrate_particles,
        "planets (more than one N-body body)": len(bodies) > 1,
        "the leapfrog integrator": phys.hydro_integrator == LEAPFROG,
        "damping zones": phys.damping,
        "AspectRatioMode != 0": phys.aspectratio_mode != 0,
        "AlphaMode != 0": phys.alpha_mode != 0,
        "StabilizeViscosity": phys.stabilize_viscosity != 0,
        "Disk: no": not phys.calculate_disk,
        "KeepDiskMassConstant": phys.keep_mass_constant,
        "the corotating frame": phys.corotating,
        "IndirectTermDiskOnDisk": phys.indirect_term_disk_on_disk,
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


def make_ref_values(fields: FieldState) -> RefValues:
    return RefValues(sigma0=fields.sigma, energy0=fields.energy,
                     vrad0=fields.vrad, vaz0=fields.vaz)


class HydroStep(nn.Module):
    """Step and CFL callables for one configuration. The geometry columns,
    the kernels' column table and the reference values are buffers:
    ``.to(device)`` moves every one of them."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, *, dtype: torch.dtype,
                 device: torch.device | str):
        super().__init__()
        bodies = bodies if bodies is not None else \
            [BodyConfig(name="DefaultStar", mass=phys.hydro_center_mass)]
        check_supported(phys, bodies)
        self.phys = phys
        self.constants = constants
        self.dtype = dtype
        self.n_bodies = len(bodies)
        self.n_hydroframe = n_hydroframe
        self.ops = kernels.KernelContext(phys, constants, geometry, dtype,
                                         device)
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            self.register_buffer(
                f"ref_{name}", getattr(ref_values, name).to(device, dtype))

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
    def derived(self, sigma, energy):
        return kernels.derived(self.ops, sigma, energy)

    def viscosity_grid(self, cs, h):
        return visc_ops.kinematic_viscosity(self.phys, self.g, cs, h)

    def bodies_on_grid(self, nb: NBodyState) -> gravity.BodiesOnGrid:
        """Body data the gas-side ops need. A lone star has no orbit to
        ramp its mass over, and no Roche lobe: its Klahr cubic smoothing
        radius is zero."""
        return gravity.BodiesOnGrid(x=nb.x, y=nb.y, mass=nb.mass,
                                    cubic_smoothing_radius=torch.zeros_like(
                                        nb.x))

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

    # ------------------------------------------------------------------
    def step(self, state: SystemState, time, dt) -> SystemState:
        """One Euler step (reference src/simulation.cpp:148-274). ``dt`` and
        ``time`` may be 0-d device tensors; nothing here reads a device
        value on the host."""
        phys, constants, g, ops = self.phys, self.constants, self.g, self.ops
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        dt = torch.as_tensor(dt, dtype=self.dtype, device=sigma.device)
        nb = state.nbody
        omega_frame = state.omega_frame
        bodies = self.bodies_on_grid(nb)

        # Disk feedback on the bodies (reference :154-158) is skipped: with
        # a lone star the frame is re-centred on it below, which removes the
        # kick, and a lone star never moves; the gas sees the same
        # potential.
        if phys.indirect_term_mode == 0:
            indirect = gravity.indirect_term_nbody_predictor(
                constants, nb, self.n_hydroframe, self.n_bodies, dt)
        else:
            indirect = gravity.indirect_term_nbody(
                constants, bodies, self.n_hydroframe, self.n_bodies)
        nb = nbody_sys.kick(nb, indirect[0], indirect[1], dt)

        nb = nbody_sys.rotate(nb, omega_frame * dt)
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps: sources, viscous kick, BCs, transport ---
        vrad, vaz = kernels.sources(ops, sigma, vrad, vaz, energy, bodies,
                                    indirect, omega_frame, dt)
        vrad, vaz, energy, qplus, qminus = kernels.viscous_kick(
            ops, sigma, vrad, vaz, energy, dt, time, compress=True)
        sigma, vrad, vaz, energy = self._apply_bcs(sigma, vrad, vaz, energy,
                                                   omega_frame)
        sigma, vrad, vaz, energy, mass_flux = kernels.transport(
            ops, sigma, vrad, vaz, energy, omega_frame, dt)
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
            monitor_acc=monitor_acc)

    def cfl_dt(self, state: SystemState) -> torch.Tensor:
        """CFL time step as a 0-d tensor (reference src/cfl.cpp:185-382)."""
        f = state.fields
        return kernels.cfl(self.ops, f.sigma, f.vrad, f.vaz, f.energy,
                           state.qplus, state.qminus)

    def advance_to(self, state: SystemState, time, last_dt, t_target):
        """Advance to ``t_target`` with the reference's dt rules
        (src/simulation.cpp:505-560): dt = min(CFL_max_var * last_dt,
        cfl_dt), stretched or clamped to land on ``t_target``; ``last_dt``
        carries the unclamped dt. One host sync per step: the landing test.

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
                               self.cfl_dt(state))
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
            if bool(clamp):
                return state, time, last_dt, n, dmin, dmax, dsum, dsq

    # ------------------------------------------------------------------
    def initial_monitor_acc(self) -> MonitorAccum:
        return MonitorAccum(mass_delta=torch.zeros(
            N_MASS_DELTA, dtype=self.dtype, device=self.device))

    def initial_system_state(self, fields: FieldState,
                             nbody: NBodyState) -> SystemState:
        """Assemble the run state; Q+/Q- seeded as at init (reference
        src/SourceEuler.cpp:1507-1547 ``compute_heating_cooling_for_CFL``)."""
        phys, constants, g = self.phys, self.constants, self.g
        sigma, energy = fields.sigma, fields.energy
        cs, _, h = self.derived(sigma, energy)
        nu = self.viscosity_grid(cs, h)
        trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
            phys, g, sigma, fields.vrad, fields.vaz, nu)
        _, qplus, qminus = energy_ops.substep3(
            phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
            0.0, 0.0)
        k = min(phys.corotation_reference_body, self.n_bodies - 1)
        scalar = lambda v: torch.tensor(v, dtype=self.dtype,  # noqa: E731
                                        device=sigma.device)
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=scalar(phys.omega_frame), frame_angle=scalar(0.0),
            corot_ref_x=nbody.x[k].clone(), corot_ref_y=nbody.y[k].clone(),
            monitor_acc=self.initial_monitor_acc())

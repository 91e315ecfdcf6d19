"""The hydro step on the Euler integrator and the CFL time step
(reference src/simulation.cpp:148-274 ``step_Euler``, src/cfl.cpp), as far
as the benchmark's configurations reach (``scope.py``).

The gas substeps take the decomposition the JAX package picks from the
configuration (``fargocpt_tpu/step.py:244-304``, ``gates`` below):

* constant gamma (the adiabatic disk): the fused ops, the potential +
  momentum sources, then the viscous kick (compression heating,
  artificial viscosity, viscosity, SubStep3), and the CFL;
* variable gamma (PVTE): the unfused composition: sources with the PVTE
  grids, the Stone-Norman artificial viscosity, the energy floor,
  viscosity, SubStep3 with surface cooling, and the CFL on the PVTE sound
  speed.

Self-gravity kicks the gas first; FLD radiative diffusion follows the
substeps. Then the boundary conditions and the FARGO transport. The dust
swarm (``particles/dust.py``) is integrated against the step-start gas
fields, after the N-body kick. Every op is its plain PyTorch version
(``ops/kernels.py``), on any device.

PVTE refreshes. The memo is a list keyed on tensor identity, cleared
after each CFL and each step; ``advance_to`` keeps it from the CFL into
its step, as the port does. The time loop is a host loop with one host
sync per step: the decision whether the step lands on the output time.
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
from .ops import artvisc, boundary, cfl as cfl_ops, eos, gravity, \
    kernels, sources as src_ops, viscosity as visc_ops
from .ops import energy as energy_ops
from .ops.boundary import RefValues
from .ops.common import ring_col
from .ops.fld import FLDConfig, FLDSolver
from .ops.pvte import PVTE
from .ops.selfgravity import SelfGravity
from .params import Physics, ARTVISC_SN, ARTVISC_TW
from .particles import dust
from .state import (FieldState, MonitorAccum, SystemState, N_ECC_STAGES,
                    N_MASS_DELTA,
                    MD_DAMP_IN_CREATE, MD_FLOOR_CREATE, MD_INNER_IN,
                    MD_INNER_OUT, MD_OUTER_IN, MD_OUTER_OUT)


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
    self-gravity solvers hold their tensors on ``device`` from the start."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, *, dtype: torch.dtype,
                 device: torch.device | str,
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
        for name in ("sigma0", "energy0", "vrad0", "vaz0"):
            self.register_buffer(
                f"ref_{name}", getattr(ref_values, name).to(device, dtype))
        needs_units = phys.variable_gamma or phys.cooling_surface_enabled \
            or phys.radiative_diffusion or phys.integrate_particles
        if needs_units and units is None:
            raise ValueError("PVTE, surface cooling, FLD and the dust need "
                             "the run's units")
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
        vals = self.pvte.gamma_mu(sigma, energy, h0)
        self._pv_memo.append((sigma, energy, vals))
        return vals

    def derived(self, sigma, energy, pv=None):
        """Sound speed, pressure and scale height; ``pv`` are stale PVTE
        grids to use instead of a refresh."""
        if pv is None:
            pv = self.pvte_vals(sigma, energy)
        return kernels.derived(self.ops, sigma, energy, pv)

    def viscosity_grid(self, cs, h):
        """The viscosity grid (reference src/viscosity/viscosity.cpp)."""
        return visc_ops.kinematic_viscosity(self.phys, self.g, cs, h)

    def bodies_on_grid(self, nb: NBodyState, time) -> gravity.BodiesOnGrid:
        """Body data the gas-side ops need at ``time`` (a float or a 0-d
        tensor): the masses ramped up, and the Klahr cubic smoothing radius
        (Roche radius x distance to the primary x the body's factor); all
        float64 tensors on the device (fargocpt_tpu/step.py:498-509): a
        lone star has no orbit to ramp its mass over and no Roche lobe."""
        return gravity.BodiesOnGrid(
            x=nb.x, y=nb.y, mass=nb.mass,
            cubic_smoothing_radius=torch.zeros_like(nb.x))

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

    def _apply_bcs(self, sigma, vrad, vaz, energy, omega_frame, nu=None):
        """The boundary conditions (fargocpt_tpu/step.py:518-599). ``nu``
        is the viscosity grid of the step's viscous substep, which the
        viscous v_rad BC reads (the reference's data[VISCOSITY]); without
        it the current fields' grid. Returns the fields and the (4,)
        damping mass deltas, zeros (the copy has no damping zones)."""
        phys = self.phys
        dmp = torch.zeros(4, dtype=sigma.dtype, device=sigma.device)
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
        (fargocpt_tpu/step.py:1274-1304). The temperature is the one the
        reference's particles sample (per-cell gamma and mu with PVTE):
        for the step-start fields the PVTE grids come from the memo, with
        no refresh of their own."""
        phys, constants = self.phys, self.constants
        pp = self.particle_params
        _, press, h0 = self.derived(sigma, energy)
        temp = eos.temperature(phys, constants, sigma, energy, press,
                               self.pvte_vals(sigma, energy))
        rho_mid = sigma / (phys.density_factor * h0)
        sg_accel = None
        if pp.disk_gravity and self.selfgravity is not None:
            sg_accel = self._sg_accels(sigma)
        return dust.integrate_expmid(
            phys, pp, constants, self.units, self.dust_grid, particles,
            rho_mid, temp, vrad, vaz, self.bodies_on_grid(nb, time),
            self.n_bodies, omega_frame, dt, sg_accel=sg_accel)

    # ------------------------------------------------------------------
    def _substeps(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies, sg_kernel):
        """Self-gravity, sources, viscosity and energy (the 'kick';
        fargocpt_tpu/step.py:662-829). Returns (vrad, vaz, energy, qplus,
        qminus, sg_kernel, pv_last, h, nu): pv_last the PVTE grids of
        SubStep3, h and nu the scale height and viscosity grid of the
        viscous substep (None after the fused viscous kick unless
        ``self.in_kick``)."""
        phys, constants, g, ops = self.phys, self.constants, self.g, self.ops
        fused = self.gates
        fused_sources = fused["sources"]
        pv = self.pvte_vals(sigma, energy)
        if self.selfgravity is not None or not fused_sources:
            cs, press, h = self.derived(sigma, energy, pv=pv)

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
                                        pot_it, omega_frame, dt)
            if not fused["viscous_kick"]:
                energy = src_ops.compression_heating(phys, g, energy, vrad,
                                                     vaz, dt)
        else:
            cell_x, cell_y = self.cell_x, self.cell_y
            pot = gravity.nbody_potential(phys, constants, g, bodies,
                                          self.n_bodies, cell_x, cell_y, h,
                                          pot_it[0], pot_it[1])
            vrad, vaz, energy = src_ops.update_with_sourceterms(
                phys, g, sigma, press, pot, vrad, vaz, energy,
                omega_frame.to(sigma.dtype), dt, pvte_vals=pv)

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
            return (*out[:5], sg_kernel, None, h_kick, nu_kick)

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
            phys, g, sigma, vrad, vaz, trr, tpp, trp, dt, nu=nu)

        qplus = qminus = torch.zeros_like(sigma)
        pv3 = None
        if phys.is_adiabatic:
            pv3 = self.pvte_vals(sigma, energy)
            energy, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
                time, dt, units=self.units, pvte_vals=pv3,
                ref=(self.ref_sigma0, self.ref_energy0))
        return vrad, vaz, energy, qplus, qminus, sg_kernel, pv3, h, nu

    def _gas_kick(self, sigma, vrad, vaz, energy, pot_it, time, dt,
                  omega_frame, bodies, sg_kernel, sor):
        """The substeps, then FLD radiative diffusion on the stale PVTE
        grids of SubStep3 (reference fld.cpp:996-1000 reads pvte::get_*
        with no refresh; fargocpt_tpu/step.py:911-934). Returns (vrad,
        vaz, energy, qplus, qminus, sg_kernel, sor, h, nu), h and nu as
        ``_substeps`` gives them."""
        (vrad, vaz, energy, qplus, qminus, sg_kernel, pv_last, h_kick,
         nu_kick) = self._substeps(sigma, vrad, vaz, energy, pot_it, time,
                                   dt, omega_frame, bodies, sg_kernel)
        if self.fld is not None:
            energy, sor = self._fld(sigma, energy, dt, sor, pv_last)
        return (vrad, vaz, energy, qplus, qminus, sg_kernel, sor, h_kick,
                nu_kick)

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
        zero for the lone star of this copy."""
        return gravity.indirect_term_nbody_predictor(
            self.constants, nb, self.n_hydroframe, self.n_bodies, dt)

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
        """One hydro step. The PVTE chain starts at ``state.pvte_guess``
        and its last link is carried to the next step."""
        with self._pvte_scope(state.pvte_guess):
            new_state = self._step_euler(state, time, dt)
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

        # disk feedback on the bodies (reference :154-158), then the N-body
        # indirect term of the kicked bodies (:160-166)
        h0 = None
        if self._feedback_on():
            h0 = self.derived(sigma, energy)[2]
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

        if phys.integrate_particles and particles is not None:
            particles = particles.replace(phi=torch.remainder(
                particles.phi - omega_frame * dt, 2.0 * math.pi))
        nb = nbody_sys.rotate(nb, omega_frame * dt)
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps and FLD
        (vrad, vaz, energy, qplus, qminus, sg_kernel, sor, _,
         nu_step) = self._gas_kick(sigma, vrad, vaz, energy, pot_it, time,
                                   dt, omega_frame, bodies, state.sg_kernel,
                                   state.fld_sor)

        # the viscous BC reads the in-kick viscosity grid (reference
        # data[VISCOSITY] from recalculate_viscosity, :196)
        sigma, vrad, vaz, energy, _ = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step)
        sigma, vrad, vaz, energy, mass_flux = kernels.transport(
            self.ops, sigma, vrad, vaz, energy, omega_frame, dt)
        sig_pre_floor = sigma
        sigma = eos.apply_sigma_floor(phys, sigma)
        floor_created = self._sum_cells((sigma - sig_pre_floor) * g.surf,
                                        self._own_int_col)
        if phys.is_adiabatic:
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)

        # --- N-body drift (reference :218-221) ---
        nb = nbody_sys.integrate(nb, constants.G, dt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)

        # the final boundary conditions
        sigma, vrad, vaz, energy, dmp = self._apply_bcs(
            sigma, vrad, vaz, energy, omega_frame, nu=nu_step)
        monitor_acc = self._mass_deltas(state, mass_flux, dmp, floor_created)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, monitor_acc=monitor_acc, fld_sor=sor,
            sg_kernel=sg_kernel, particles=particles)

    def _corotation_body(self) -> int:
        """The body the corotating frame follows (indices past the last
        body take the last, as the JAX package's indexing clamps them)."""
        return min(self.phys.corotation_reference_body, self.n_bodies - 1)

    def cfl_dt(self, state: SystemState, time=0.0) -> torch.Tensor:
        """CFL time step as a 0-d tensor (reference src/cfl.cpp:185-382);
        a PVTE refresh warms from ``state.pvte_guess``."""
        f = state.fields
        phys = self.phys
        with self._pvte_scope(state.pvte_guess):
            if self.gates["cfl"]:
                dt = kernels.cfl(self.ops, f.sigma, f.vrad, f.vaz, f.energy,
                                 state.qplus, state.qminus)
            else:
                cs, _, h = self.derived(f.sigma, f.energy)
                nu = self.viscosity_grid(cs, h)
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
        command line's ``-N``). ``first_step``, the number of the run's
        steps before this call, is the port's argument and unused here.

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
                dt = torch.minimum(self.phys.cfl_max_var * last_dt,
                                   self.cfl_dt(state, time))
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
        with the constant-gamma SubStep3, as the JAX package seeds them."""
        phys, constants, g = self.phys, self.constants, self.g
        sigma, energy = fields.sigma, fields.energy
        with self._pvte_scope(None):
            cs, _, h = self.derived(sigma, energy)
            nu = self.viscosity_grid(cs, h) if phys.is_adiabatic else None
        qplus = qminus = torch.zeros_like(sigma)
        if phys.is_adiabatic:
            trr, tpp, trp, divv = visc_ops.viscous_stress_tensor(
                phys, g, sigma, fields.vrad, fields.vaz, nu)
            _, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv,
                h, 0.0, 0.0, units=self.units,
                ref=(self.ref_sigma0, self.ref_energy0))
        k = self._corotation_body()
        scalar = lambda v: torch.tensor(v, dtype=self.dtype,  # noqa: E731
                                        device=sigma.device)
        fld_sor = self.fld.initial_sor_state(self.dtype, self.device) \
            if self.fld is not None and self.fld.config.auto_omega else None
        sg_kernel = self.selfgravity.initial_kernel_state() \
            if self.selfgravity is not None and phys.is_adiabatic \
            and self.selfgravity.supports_in_run_update() else None
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=scalar(phys.omega_frame), frame_angle=scalar(0.0),
            corot_ref_x=nbody.x[k].clone(), corot_ref_y=nbody.y[k].clone(),
            monitor_acc=self.initial_monitor_acc(), pvte_guess=None,
            fld_sor=fld_sor, sg_kernel=sg_kernel)

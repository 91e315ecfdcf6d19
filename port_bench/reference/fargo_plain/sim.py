"""Simulation: setup from a config and the outer time loop
(reference src/simulation.cpp:505-560 ``sim::run`` and src/main.cpp),
as far as the benchmark's configurations reach (``scope.py``).

``begin()`` then ``advance_monitor()`` drive it as the port's run path
does; ``monitor_hooks`` and ``snapshot_hooks`` run at the monitor and
snapshot boundaries; ``time`` and ``last_dt`` are 0-d tensors on the run
device. Everything lives on ``device``, the GPU (``"cuda"``) unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from . import initial, scope, units as u
from .config import Config
from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .ops import boundary
from .params import physics_from_config
from .particles import dust
from .state import FieldState, SystemState
from .step import HydroStep, make_ref_values

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class RunSettings:
    """Output cadence & run length (reference src/Interpret.cpp:200-202)."""
    n_snapshots: int = 1000
    n_monitor: int = 10
    monitor_timestep: float = 1.0
    first_dt: float = 1e-9
    outdir: str = "output/out"
    write_at_every_timestep: bool = True

    @classmethod
    def from_config(cls, cfg: Config, outdir: str | None = None) -> "RunSettings":
        cfg_outdir = cfg.get("OutputDir", "output/out", type=str)
        return cls(
            n_snapshots=cfg.get("Nsnapshots", 1000, type=int),
            n_monitor=cfg.get("Nmonitor", 10, type=int),
            monitor_timestep=cfg.get("MonitorTimestep", 1.0, dim=u.DIM_TIME,
                                     type=float),
            first_dt=cfg.get("FirstDT", 1e-9, dim=u.DIM_TIME, type=float),
            outdir=outdir or cfg_outdir,
            write_at_every_timestep=cfg.get_flag("WriteAtEveryTimestep", True),
        )


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available")
    return device


class Simulation:
    """End-to-end simulation: config -> grid -> ICs -> stepping."""

    def __init__(self, cfg: Config, outdir: str | None = None,
                 dtype: str = "float64", device: str | torch.device = "cuda",
                 transport_route: str | None = None):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[dtype]
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.units = u.Units.from_config_strings(
            str(cfg.get_raw("l0", "1.0")), str(cfg.get_raw("m0", "1.0")),
            str(cfg.get_raw("t0")) if "t0" in cfg else None,
            str(cfg.get_raw("temp0")) if "temp0" in cfg else None)
        self.constants = Constants.from_units(self.units)
        cfg.set_units(self.units)
        self.phys = physics_from_config(cfg, self.units, dtype=dtype)

        self.bodies = nbody_sys.parse_bodies(cfg, self.units)
        scope.refuse_outside(self.phys, self.bodies, cfg, transport_route)
        self.n_hydroframe = nbody_sys.hydroframe_center_count(
            cfg, len(self.bodies))
        nb_init = nbody_sys.initialize_system(self.bodies, self.constants.G,
                                              self.n_hydroframe)
        self.phys = self.phys.with_(hydro_center_mass=float(
            nb_init["mass"][:self.n_hydroframe].sum()))
        boundary.check_supported(self.phys)

        self.geometry = Geometry.from_config(cfg)
        self.settings = RunSettings.from_config(cfg, outdir)

        # the particle keys are consulted even when particles are off (the
        # reference always reads them, src/parameters.cpp:854-932)
        pp, particles = self._setup_particles(cfg)
        fields, self.phys = initial.build_initial_state(
            self.phys, self.constants, self.geometry, dtype=self.dtype,
            device=self.device)
        self.stepper = HydroStep(
            self.phys, self.constants, self.geometry, make_ref_values(fields),
            self.bodies, self.n_hydroframe, dtype=self.dtype,
            device=self.device, units=self.units,
            transport_route=transport_route,
            particle_params=pp if self.phys.integrate_particles else None)
        sg = self.stepper.selfgravity
        if sg is not None and not self.phys.centrifugal_balance:
            # equilibrium v_az with the axisymmetric self-gravity pull
            # (reference src/init.cpp:1722-1724 + selfgravity.cpp:749),
            # which CentrifugalBalance's v_az replaces
            vaz = sg.init_azimuthal_velocity_correction(
                self.phys, fields.sigma, fields.vaz.cpu().numpy())
            fields = fields.replace(vaz=torch.tensor(
                vaz, dtype=self.dtype, device=self.device))
        # reference src/init.cpp:335-341: snapshot refs, BCs (those that
        # read the bodies with the initial ones), refs again
        nbody = nbody_sys.make_state(nb_init, self.device)
        self.stepper.set_ref_values(make_ref_values(fields))
        fields = self.stepper.apply_bcs(fields)
        self.stepper.set_ref_values(make_ref_values(fields))
        self.state: SystemState = self.stepper.initial_system_state(
            fields, nbody)
        if self.phys.integrate_particles:
            self.state = self.state.replace(particles=particles)

        self.time = self._scalar(0.0)
        self.last_dt = self._scalar(self.settings.first_dt)
        # a fresh start grows last_dt twice before the first loop step
        # (src/main.cpp:117 and src/simulation.cpp:467-469)
        self._dt_primed = False
        # a restored run resumes without writing the t = 0 output
        # (output.restore_simulation sets it)
        self._restored = False
        self.n_monitor = 0
        self.n_snapshot = 0
        self.n_hydro_iter = 0
        # what calculate_time_step and run advance the state with in place
        # of the stepper when set: an object with its cfl_dt and
        # advance_to on the global state (parallel.run's sharded advancer)
        self.advancer = None
        # callables (sim) run at the monitor and snapshot boundaries
        self.monitor_hooks = []
        self.snapshot_hooks = []
        self.monitor_stats: dict = {}
        # every config key has been consulted by now; a leftover key is a
        # typo (reference src/main.cpp:110)
        cfg.exit_on_unknown_key()

    def _setup_particles(self, cfg: Config):
        """Parse the particle configuration and build the initial swarm
        (reference src/parameters.cpp particle section + particles.cpp:516)."""
        n = cfg.get("NumberOfParticles", 0, type=int)
        n_species = max(cfg.get("ParticleSpeciesNumber", 1, type=int), 1)
        radius0 = cfg.get("ParticleRadius", 100.0 / self.units.length,
                          dim=u.DIM_LENGTH, type=float)
        factor = cfg.get("ParticleRadiusIncreaseFactor", 10.0, type=float)
        density = cfg.get("ParticleDensity", 2.65 / self.units.density,
                          dim=u.DIM_DENSITY, type=float)
        rmin_p = cfg.get("ParticleMinimumRadius", self.geometry.rmin,
                         dim=u.DIM_LENGTH, type=float)
        rmax_p = cfg.get("ParticleMaximumRadius", self.geometry.rmax,
                         dim=u.DIM_LENGTH, type=float)
        cartesian = cfg.get_flag("CartesianParticles", False)
        integrator = cfg.get_lowercase("ParticleIntegrator", "midpoint")
        if cartesian or not integrator.startswith("m") \
                or cfg.get_flag("ParticleDustDiffusion", False):
            raise ValueError("the benchmark's reference covers the polar "
                             "midpoint integrator without dust diffusion")
        pp = dust.ParticleParams(
            density=density,
            cartesian=cartesian,
            gas_drag=cfg.get_flag("ParticleGasDragEnabled", True),
            disk_gravity=cfg.get_flag("ParticleDiskGravityEnabled", False),
            diffusion=cfg.get_flag("ParticleDustDiffusion", False),
            integrator=integrator,
            min_escape_radius=cfg.get("ParticleMinimumEscapeRadius", rmin_p,
                                      dim=u.DIM_LENGTH, type=float),
            max_escape_radius=cfg.get("ParticleMaximumEscapeRadius", rmax_p,
                                      dim=u.DIM_LENGTH, type=float))
        sizes = radius0 * factor ** (np.arange(n) % n_species)
        particles = dust.init_particles(
            n, rmin_p, rmax_p,
            cfg.get("ParticleSurfaceDensitySlope",
                    self.phys.sigma_slope, type=float),
            sizes, self.constants.G * self.phys.hydro_center_mass,
            eccentricity=cfg.get("ParticleEccentricity", 0.0, type=float),
            seed=cfg.get("RandomSeed", 1337, type=int),
            dtype=self.dtype, device=self.device)
        return pp, particles

    def _scalar(self, value) -> torch.Tensor:
        return torch.tensor(value, dtype=self.dtype, device=self.device)

    @property
    def fields(self) -> FieldState:
        return self.state.fields

    # ------------------------------------------------------------------
    def calculate_time_step(self) -> torch.Tensor:
        """dt = min(CFL_max_var * last_dt, cfl_dt) as a 0-d device tensor
        (reference src/simulation.cpp:100-117); no host sync. Disk: no
        keeps last_dt."""
        if not self.phys.calculate_disk:
            return self.last_dt
        dt = torch.minimum(self.phys.cfl_max_var * self.last_dt,
                           (self.advancer or self.stepper).cfl_dt(
                               self.state, self.time))
        self.last_dt = dt
        return dt

    def step_once(self, dt):
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        self.state = self.stepper.step(self.state, self.time, dt)
        self.time = self.time + dt
        self.n_hydro_iter += 1


    def begin(self):
        """What precedes the loop: a fresh start grows last_dt twice
        (src/main.cpp:117, src/simulation.cpp:467) and writes the t = 0
        output; a restored run does neither (src/simulation.cpp:505-560
        writes no initial output, and re-registering the restored snapshot
        would duplicate list.txt rows)."""
        if not self._dt_primed:
            self.calculate_time_step()
            self.calculate_time_step()
            self._dt_primed = True
        if not self._restored:
            self._handle_outputs(initial=True)

    def advance_monitor(self, max_steps: int | None = None) -> bool:
        """One monitor interval: ``advance_to`` the next output time, the
        interval's dt statistics (one host read), then the hooks. With
        ``max_steps`` it may stop short of the output time: then it runs
        no hook and returns False."""
        t_target = (self.n_monitor + 1) * self.settings.monitor_timestep
        wall0 = _time.time()
        (self.state, self.time, self.last_dt, n, *dt_stats) = \
            (self.advancer or self.stepper).advance_to(
                self.state, self.time, self.last_dt, t_target, max_steps,
                self.n_hydro_iter)
        dt_min, dt_max, dt_sum, dt_sq = torch.stack(dt_stats).tolist()
        self.n_hydro_iter += n
        self.monitor_stats = {
            "n_steps": n, "walltime": _time.time() - wall0,
            "dt_min": dt_min, "dt_max": dt_max, "dt_sum": dt_sum,
            "dt_sq": dt_sq,
        }
        if max_steps is not None and n >= max_steps \
                and not bool(self.time == t_target):
            return False
        self.n_monitor += 1
        self._handle_outputs()
        return True

    def _handle_outputs(self, initial: bool = False):
        s = self.settings
        self.n_snapshot = self.n_monitor // s.n_monitor
        write_snapshot = (s.n_monitor * self.n_snapshot == self.n_monitor)
        for hook in self.monitor_hooks:
            hook(self)
        if write_snapshot:
            for hook in self.snapshot_hooks:
                hook(self)

    # convenience -------------------------------------------------------



"""Simulation: setup from a config and the outer time loop
(reference src/simulation.cpp:505-560 ``sim::run`` and src/main.cpp).

    sim = Simulation(Config.from_dict({...}), dtype="float32")
    sim.run()                      # through the configured output times
    dt = sim.calculate_time_step() # or drive single steps
    sim.step_once(dt)

``monitor_hooks`` and ``snapshot_hooks`` run at the monitor and snapshot
boundaries of ``run`` (``output.OutputWriter`` registers its writers
there); ``time`` and ``last_dt`` are 0-d tensors on the run device, which
the host reads at those boundaries only.

Everything lives on ``device``, the GPU (``"cuda"``) unless the caller
asks for ``device="cpu"``; ``"cuda"`` without a card raises.
``transport_route`` sends the FARGO transport down a named route
(``ops/kernels.ROUTES``) where the grid would pick its own. Setting
``sim.stepper.debug_nans`` checks the state for NaNs and infinities
after every step and raises ``FloatingPointError`` at the first.
"""

from __future__ import annotations

import dataclasses
import time as _time
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from . import initial, units as u
from .config import Config
from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .ops import boundary, diskmodel
from .params import physics_from_config
from .particles import dust
from .state import FieldState, SystemState, check_finite
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


def load_custom_boundary(mod_path: str):
    """``custom_boundary`` of a .py file path or an importable module name
    (the run-time counterpart of the reference's compile-time
    src/boundary_conditions/custom.cpp template;
    fargocpt_tpu/sim.py:55-79)."""
    import importlib
    import importlib.util
    from pathlib import Path

    if mod_path.endswith(".py") or "/" in mod_path:
        p = Path(mod_path)
        if not p.exists():
            raise FileNotFoundError(
                f"CustomBoundaryModule file not found: {mod_path}")
        spec = importlib.util.spec_from_file_location(
            "fargocpt_torch_custom_boundary", str(p))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_path)
    fn = getattr(mod, "custom_boundary", None)
    if fn is None:
        raise AttributeError(
            f"CustomBoundaryModule {mod_path!r} must define "
            "custom_boundary(g, sigma, vrad, vaz, energy, omega_frame)")
    return fn


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
        shock_tube = cfg.get("ShockTube", 0, type=int)
        # the base-unit keys are consulted on the shock-tube branch too,
        # which overrides them (reference src/init.cpp:446-520)
        for key in ("l0", "m0", "t0", "temp0"):
            cfg.get_raw(key)
        if shock_tube == 2:
            # the PVTE shock tube's unit table (src/init.cpp:540-615)
            self.units = u.pvte_shock_tube_units()
            self.constants = Constants.shock_tube()
        elif shock_tube:
            self.units = u.shock_tube_units()
            self.constants = Constants.shock_tube()
        else:
            self.units = u.Units.from_config_strings(
                str(cfg.get_raw("l0", "1.0")), str(cfg.get_raw("m0", "1.0")),
                str(cfg.get_raw("t0")) if "t0" in cfg else None,
                str(cfg.get_raw("temp0")) if "temp0" in cfg else None)
            self.constants = Constants.from_units(self.units)
        cfg.set_units(self.units)
        self.phys = physics_from_config(cfg, self.units, dtype=dtype)

        self.bodies = nbody_sys.parse_bodies(cfg, self.units)
        # the deprecated global Klahr & Kley smoothing radius: every planet
        # whose own cubic smoothing factor is unset takes it (reference
        # src/nbody/planetary_system.cpp:94-115)
        klahr_r = cfg.get("KlahrSmoothingRadius", 0.0, type=float)
        if klahr_r > 0.0:
            warnings.warn("KlahrSmoothingRadius is deprecated; use the "
                          "per-body 'cubic smoothing factor'")
            self.bodies = [
                dataclasses.replace(b, cubic_smoothing_factor=klahr_r)
                if (b.semi_major_axis > 1e-10
                    and b.cubic_smoothing_factor == 0.0) else b
                for b in self.bodies]
        if self.phys.cic_planet:
            # CICPLANET: a planet starts at the nearest cell-centre radius
            # (reference src/nbody/planetary_system.cpp:198-204)
            rmed = Geometry.from_config(cfg).rmed
            snapped = []
            for b in self.bodies:
                if b.semi_major_axis > 1e-10:
                    if b.eccentricity > 0.0:
                        raise ValueError("CICPLANET with eccentricity > 0 "
                                         "is not supported (as in the "
                                         "reference)")
                    b = dataclasses.replace(b, semi_major_axis=float(
                        rmed[int(np.argmin(np.abs(rmed
                                                  - b.semi_major_axis)))]))
                snapped.append(b)
            self.bodies = snapped
        self.n_hydroframe = nbody_sys.hydroframe_center_count(
            cfg, len(self.bodies))
        nb_init = nbody_sys.initialize_system(self.bodies, self.constants.G,
                                              self.n_hydroframe)
        self.phys = self.phys.with_(hydro_center_mass=float(
            nb_init["mass"][:self.n_hydroframe].sum()))
        if self.phys.corotating and len(self.bodies) > 1:
            # the frame rotates with the reference body from t = 0, so the
            # fields are built in the rotating frame (reference
            # src/init.cpp:259-263 sets OmegaFrame before them;
            # fargocpt_tpu/sim.py:239-249)
            k = min(self.phys.corotation_reference_body,
                    len(self.bodies) - 1)
            x, y = float(nb_init["x"][k]), float(nb_init["y"][k])
            vx, vy = float(nb_init["vx"][k]), float(nb_init["vy"][k])
            self.phys = self.phys.with_(
                omega_frame=(x * vy - y * vx) / max(x * x + y * y, 1e-300))
        if any(b.irradiate for b in self.bodies):
            self.phys = self.phys.with_(heating_star=True)
        boundary.check_supported(self.phys)

        self.geometry = Geometry.from_config(cfg)
        self.settings = RunSettings.from_config(cfg, outdir)

        # the particle keys are consulted even when particles are off (the
        # reference always reads them, src/parameters.cpp:854-932)
        pp, particles = self._setup_particles(cfg)
        # the binary quadrupole moment of the v_az support (reference
        # src/Theo.cpp:58-78)
        quad_moment = diskmodel.binary_quadrupole_moment(
            self.bodies, self.n_hydroframe) \
            if self.phys.vaz_quadrupole_support else 0.0
        fields, self.phys = initial.build_initial_state(
            self.phys, self.constants, self.geometry, quad_moment,
            nbody=nb_init, dtype=self.dtype, device=self.device)
        self.stepper = HydroStep(
            self.phys, self.constants, self.geometry, make_ref_values(fields),
            self.bodies, self.n_hydroframe, dtype=self.dtype,
            device=self.device, quad_moment=quad_moment, units=self.units,
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
        fields = self.stepper.apply_bcs(fields, nb=nbody)
        self.stepper.set_ref_values(make_ref_values(fields))
        self.state: SystemState = self.stepper.initial_system_state(
            fields, nbody)
        # the user's boundary function (reference
        # src/boundary_conditions/custom.cpp, a source template there):
        # CustomBoundaryModule names a .py file or an importable module
        # defining ``custom_boundary(g, sigma, vrad, vaz, energy,
        # omega_frame) -> (sigma, vrad, vaz, energy)`` on the port's Geom
        # and torch tensors, applied after the named boundaries of every
        # boundary call once Inner/OuterBoundary is "custom" (not at the
        # initial one, as in the JAX package); a library user may set
        # ``sim.stepper.custom_bc`` before the first step instead
        mod_path = cfg.get("CustomBoundaryModule", "", type=str)
        if mod_path:
            self.stepper.custom_bc = load_custom_boundary(mod_path)
        elif "custom" in (self.phys.composite_inner,
                          self.phys.composite_outer):
            warnings.warn(
                "Inner/OuterBoundary is 'custom' but no "
                "CustomBoundaryModule is configured and no custom_bc was "
                "registered; the custom hook will be a no-op unless "
                "sim.stepper.custom_bc is set before the first step")
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
        if cartesian and integrator.startswith("m"):
            # exponential midpoint is polar-only (reference
            # parameters.cpp:927-932)
            warnings.warn("CartesianParticles is only supported by the "
                          "adaptive integrator; disabled for midpoint")
            cartesian = False
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
        if self.stepper.debug_nans:
            check_finite(self.state, self.n_hydro_iter)

    def run(self, max_steps: int | None = None):
        """Outer loop (reference src/simulation.cpp:505-560): one
        ``advance_monitor`` per monitor interval, until the last output
        time or ``max_steps`` hydro steps in all."""
        total_monitors = self.settings.n_snapshots * self.settings.n_monitor
        self.begin()
        while self.n_monitor < total_monitors:
            left = None if max_steps is None else max_steps - self.n_hydro_iter
            if left is not None and left <= 0:
                break
            if not self.advance_monitor(left):
                break

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
    @classmethod
    def from_file(cls, path: str, outdir: str | None = None,
                  dtype: str = "float64", device: str | torch.device = "cuda",
                  transport_route: str | None = None) -> "Simulation":
        return cls(Config.from_file(path), outdir=outdir, dtype=dtype,
                   device=device, transport_route=transport_route)

    def np_fields(self) -> dict[str, np.ndarray]:
        f = self.fields
        return {"Sigma": f.sigma.cpu().numpy(), "vrad": f.vrad.cpu().numpy(),
                "vazi": f.vaz.cpu().numpy(),
                "energy": f.energy.cpu().numpy()}

    def orbital_elements(self, k: int) -> dict:
        """Keplerian elements of body k about the accumulated inner mass
        (reference src/nbody/planetary_system.cpp:773-820)."""
        nb = self.state.nbody
        x, y, vx, vy, m = torch.stack(
            [nb.x, nb.y, nb.vx, nb.vy, nb.mass]).cpu().numpy()
        if k == 0 and self.n_hydroframe == 1:
            return nbody_sys.orbital_elements(0, 0, 0, 0, 0, 0, 1)
        # elements relative to the COM of bodies 0..k-1
        mc = m[:k].sum()
        cx = (m[:k] * x[:k]).sum() / mc
        cy = (m[:k] * y[:k]).sum() / mc
        cvx = (m[:k] * vx[:k]).sum() / mc
        cvy = (m[:k] * vy[:k]).sum() / mc
        return nbody_sys.orbital_elements(
            x[k] - cx, y[k] - cy, vx[k] - cvx, vy[k] - cvy, mc, m[k],
            self.constants.G)


def reachable_tensors(root, prefix: str = "sim"):
    """Yield (path, tensor) for every tensor reachable from ``root``
    through attributes, dataclass fields, module buffers/parameters,
    dicts, lists and tuples."""
    seen: set[int] = set()
    stack = [(prefix, root)]
    while stack:
        path, obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if torch.is_tensor(obj):
            yield path, obj
        elif isinstance(obj, nn.Module):
            for name, t in obj.named_buffers(recurse=False):
                stack.append((f"{path}.{name}", t))
            for name, t in obj.named_parameters(recurse=False):
                stack.append((f"{path}.{name}", t))
            for name, m in obj.named_children():
                stack.append((f"{path}.{name}", m))
            for name, v in vars(obj).items():
                if not name.startswith("_"):
                    stack.append((f"{path}.{name}", v))
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                stack.append((f"{path}.{f.name}", getattr(obj, f.name)))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                stack.append((f"{path}[{k!r}]", v))
        elif isinstance(obj, (list, tuple)):
            for k, v in enumerate(obj):
                stack.append((f"{path}[{k}]", v))
        elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
                "fargocpt_torch"):
            for name, v in vars(obj).items():
                stack.append((f"{path}.{name}", v))

"""Snapshot / monitor output and restart: the JAX package's layout
(``fargocpt_tpu/output.py``), file for file, from a run on any device.

Re-derivation of reference src/output.cpp; the on-disk layout is kept
byte-compatible where analysis tooling depends on it —

  outdir/
    dimensions.dat            (reference src/parameters.cpp:1127-1177)
    used_rad.dat              (interface radii, src/init.cpp:232-252)
    units.yml, constants.yml
    info2D.yml, info1D.yml    (self-describing variable lists, :788-850)
    snapshots/list.txt        (snapshot registry, :183-191)
    snapshots/timeSnapshot.dat
    snapshots/reference/      (the reference fields, written once)
    snapshots/<N>/Sigma.dat   (raw little-endian float64, NR x NAZ)
    snapshots/<N>/vrad.dat    ((NR+1) x NAZ)
    snapshots/<N>/vazi.dat, energy.dat, Temperature.dat, <name>1D.dat, ...
    snapshots/<N>/misc.bin    (binary struct, src/output.h:16-24)
    snapshots/<N>/nbody.bin   (per-body state)
    snapshots/<N>/massflow_tracker.bin (the Roche-lobe tracker:
                              [0, averaging time, rate] float64)
    snapshots/<N>/config.yml
    monitor/Quantities.dat    (~20 scalars/monitor, :326-490)
    monitor/timestepLogging.dat (dt statistics, src/hydro_dt_logger.cpp)
    monitor/nbody{i}.dat      (per-body orbit data)

A run of one process writes the serial layout, with or without
``DistributedOutput`` (as the JAX package does when the fields live on one
device, fargocpt_tpu/output.py:258-259). A run sharded over ranks
(``parallel/run.py``) with ``DistributedOutput`` writes each grid as row
files, ``<Base>.r<start>-<stop>.dat`` of the rows each rank owns
(``write_rows``; fargocpt_tpu/output.py:953-1000), and rank 0 the rest of
the snapshot; ``check_supported`` refuses by name what such a run does
not write yet. ``restore_simulation`` reads row files as it reads whole
ones. Tensors reach the host at a boundary with
one synchronise (``to_host``); the field dumps go through the native
background writer (``native.AsyncFileWriter``) as float64. The monitor
writers run as the span ``output.monitor``; a snapshot leaves a
``telemetry.SnapshotRecord`` (its bytes and the host seconds of its copy
to the host, its dumps and their flush) and runs as the span
``output.snapshot`` with its parts as children. This module
imports ``torch`` only inside its functions, so ``fargocpt_torch data``
(``analysis``, which reads ``load_misc`` from here) stays free of it.
"""

from __future__ import annotations

import math
import re
import shutil
import struct
from pathlib import Path

import numpy as np
import yaml

# column layout of Quantities.dat (reference src/output.cpp:39-76, v2.5)
QUANTITIES_COLUMNS = [
    "snapshot number", "monitor number", "time", "mass", "radius",
    "angular momentum", "total energy", "internal energy",
    "kinematic energy", "potential energy", "radial kinetic energy",
    "azimuthal kinetic energy", "eccentricity", "periastron",
    "viscous dissipation", "luminosity", "pdivv",
    "inner boundary mass inflow", "inner boundary mass outflow",
    "outer boundary mass inflow", "outer boundary mass outflow",
    "wave damping inner mass creation", "wave damping inner mass removal",
    "wave damping outer mass creation", "wave damping outer mass removal",
    "density floor mass creation", "aspect ratio",
    "indirect term nbody x", "indirect term nbody y",
    "indirect term disk x", "indirect term disk y", "frame angle",
    "advection torque", "viscous torque", "gravitational torque",
]
# the monitor's mass bookkeeping, in the order of state.MonitorAccum's
# mass_delta (reference src/types.h:30-60)
MASS_DELTA_COLUMNS = [
    "inner boundary mass inflow", "inner boundary mass outflow",
    "outer boundary mass inflow", "outer boundary mass outflow",
    "wave damping inner mass creation", "wave damping inner mass removal",
    "wave damping outer mass creation", "wave damping outer mass removal",
    "density floor mass creation"]

MISC_STRUCT = "=IIddddQ"   # reference src/output.h:16-24 misc_entry

# the accumulated monitor grids a snapshot writes (reference
# src/data.cpp:277 set_clear_after_write, src/quantities.cpp:743-781,
# 963-973): each grid's file name, and whether it is divided by the
# snapshot interval (Nmonitor x MonitorTimestep) or, the alpha means, by
# MonitorTimestep (quantities.cpp:991-996)
MONITOR_FILES = {"massflow": ("MassFlow", True),
                 "t_adv": ("AdvectionTorque", True),
                 "t_visc": ("ViscousTorque", True),
                 "t_grav": ("GravitationalTorqueNotIntegrated", True),
                 "alpha_grav_mean": ("alpha_grav_mean", False),
                 "alpha_reynolds_mean": ("alpha_reynolds_mean", False)}
# the columns of monitor/eccentricity_change.dat after the snapshot and
# monitor numbers and the time (reference src/output.cpp:1275-1372)
ECC_STAGES = ("source", "artvisc", "viscosity", "transport", "damping")


def check_supported(phys, n_ranks: int = 1) -> None:
    """Raise NotImplementedError for every output a run over ``n_ranks``
    ranks does not write yet, naming it. One rank writes everything; a
    sharded run without DistributedOutput gathers its state and writes the
    serial layout; with DistributedOutput it writes the prognostic grids,
    Q+ / Q-, the PVTE cache and the temperature as row files and the 1-D
    files of the serial layout, not yet the outputs below."""
    if n_ranks <= 1 or not phys.distributed_output:
        return
    unsupported = {
        "the Write* 2-D fields": bool(phys.snapshot_fields),
        "the monitor grids (WriteMassFlow, WriteGasTorques, "
        "WriteAlphaGravMean, WriteAlphaReynoldsMean)":
            phys.write_massflow or phys.write_gas_torques
            or phys.write_alpha_grav_mean or phys.write_alpha_reynolds_mean,
        "WriteTorques": phys.write_torques,
        "WriteRadialLuminosity / WriteRadialDissipation":
            phys.write_radial_luminosity or phys.write_radial_dissipation,
        "the dust particles' file": phys.integrate_particles,
        "the Roche-lobe tracker's file": phys.rochelobe_overflow,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(
                f"{name} in the row files of a sharded run "
                "(DistributedOutput) is not ported yet")


def to_host(tensors: dict) -> dict[str, np.ndarray]:
    """numpy copies of a dict of tensors with one synchronise: copies from
    a GPU are queued into pinned host memory and waited for once."""
    import torch
    from . import telemetry
    telemetry.count("sync.output.to_host")
    host = {k: t.detach().to("cpu", non_blocking=True)
            for k, t in tensors.items()}
    if any(t.device.type == "cuda" for t in tensors.values()):
        torch.cuda.synchronize()
    return {k: v.numpy() for k, v in host.items()}


class OutputWriter:
    """Writes reference-layout output for a Simulation."""

    def __init__(self, sim, outdir: str | None = None):
        check_supported(sim.phys)
        self.sim = sim
        self.outdir = Path(outdir or sim.settings.outdir)
        self.snapshot_dir = None
        self._quantities_initialized = False
        # native async writer for the large field dumps
        from .native import AsyncFileWriter
        self._awriter = AsyncFileWriter()
        self._setup()
        # 'reference' snapshot holding the damping/reference-BC target
        # fields (reference src/output.cpp:183-248 register_output writes a
        # reference snapshot once)
        refdir = self.outdir / "snapshots" / "reference"
        if not refdir.exists():
            refdir.mkdir(parents=True)
            st = sim.stepper
            ref = to_host({"Sigma": st.ref_sigma0, "energy": st.ref_energy0,
                           "vrad": st.ref_vrad0, "vazi": st.ref_vaz0})
            for name, arr in ref.items():
                np.asarray(arr, np.float64).tofile(refdir / f"{name}.dat")
        # WriteDefaultValues: dump every config key the run consulted,
        # including the defaults it fell back to (reference
        # src/Interpret.cpp:695-697 cfg.write_default)
        if sim.phys.write_default_values:
            defaults = getattr(getattr(sim, "cfg", None),
                               "consulted_values", lambda: {})()
            (self.outdir / "default_config.yml").write_text(
                yaml.safe_dump(defaults, sort_keys=True,
                               default_flow_style=False))
        # hook into the simulation
        sim.monitor_hooks.append(self._on_monitor)
        sim.snapshot_hooks.append(self._on_snapshot)

    @property
    def is_native(self) -> bool:
        """Whether the field dumps go through the native writer."""
        return self._awriter.is_native

    # ------------------------------------------------------------------
    def _setup(self):
        for sub in ("snapshots", "monitor", "parameters"):
            (self.outdir / sub).mkdir(parents=True, exist_ok=True)
        # output-format identifier: the reference's python Loader refuses
        # to open a directory without it (reference src/output.cpp:205
        # write_output_version, python_module/fargocpt/data.py
        # _check_output_dir)
        (self.outdir / "fargocpt_output_v1_4").touch()
        self._write_dimensions()
        self._write_used_rad()
        self._write_units()
        self._write_info2d()
        self._write_info1d()
        if self.sim.state.particles is not None:
            self._write_info_particles()
        # config provenance: library-constructed runs dump the raw config
        # dict; the CLI overwrites this with a copy of the actual setup
        # file (reference src/output.cpp:249-304 always saves its config)
        setup = self.outdir / "parameters" / "setup.yml"
        if not setup.exists():
            cfg = getattr(self.sim, "cfg", None)
            if cfg is not None and getattr(cfg, "_raw", None) is not None:
                setup.write_text(yaml.safe_dump(
                    {cfg._orig_case[k]: v for k, v in cfg._raw.items()},
                    sort_keys=False, default_flow_style=False))

    def _write_dimensions(self):
        g = self.sim.geometry
        spacing = {"logarithmic": "Logarithmic", "arithmetic": "Arithmetic",
                   "exponential": "Exponential",
                   "custom": "Custom"}[g.spacing]
        with open(self.outdir / "dimensions.dat", "w") as f:
            f.write("#RMIN\tRMAX\tPHIMIN\tPHIMAX          \tNRAD\tNAZ\t"
                    "NGHRAD\tNGHAZ\tRadial_spacing\n")
            f.write(f"{g.rmin:.16g}\t{g.rmax:.16g}\t{0.0:.16g}\t"
                    f"{2 * math.pi:.16g}\t{g.nrad}\t{g.naz}\t1\t1\t"
                    f"{spacing}\n")

    def _write_used_rad(self):
        with open(self.outdir / "used_rad.dat", "w") as f:
            for r in self.sim.geometry.radii:
                f.write(f"{r:.18g}\n")

    def _write_units(self):
        un = self.sim.units
        units = {
            "length": {"unit": "cm", "factor": un.length},
            "mass": {"unit": "g", "factor": un.mass},
            "time": {"unit": "s", "factor": un.time},
            "temperature": {"unit": "K", "factor": un.temperature},
            "velocity": {"unit": "cm s^-1", "factor": un.velocity},
            "mass surface density": {"unit": "g cm^-2",
                                     "factor": un.surface_density},
            "energy surface density": {"unit": "erg cm^-2",
                                       "factor": un.energy_density},
        }
        with open(self.outdir / "units.yml", "w") as f:
            yaml.safe_dump(units, f)
        c = self.sim.constants
        with open(self.outdir / "constants.yml", "w") as f:
            yaml.safe_dump({"G": c.G, "R": c.R, "sigma_sb": c.sigma_sb,
                            "c": c.c}, f)

    def _field_specs(self):
        un = self.sim.units
        g = self.sim.geometry
        return {
            "Sigma": dict(unit="g cm^-2", factor=un.surface_density,
                          nrad=g.nrad, vector=False),
            "vrad": dict(unit="cm s^-1", factor=un.velocity,
                         nrad=g.nrad + 1, vector=True),
            "vazi": dict(unit="cm s^-1", factor=un.velocity,
                         nrad=g.nrad, vector=False),
            "energy": dict(unit="erg cm^-2", factor=un.energy_density,
                           nrad=g.nrad, vector=False),
            "Temperature": dict(unit="K", factor=un.temperature,
                                nrad=g.nrad, vector=False),
        }

    def _write_info2d(self):
        g = self.sim.geometry
        lines = ["# 2D output variable descriptions", "# version 0.1", ""]
        for name, spec in self._field_specs().items():
            lines += [
                f"{name}:",
                f"  cgs symbols: {spec['unit']}",
                f"  code_to_cgs_factor: {spec['factor']:.17g}",
                f"  unit: {spec['factor']:.17g} {spec['unit']}",
                f"  Nrad: {spec['nrad']}",
                f"  Nazi: {g.naz}",
                "  bigendian: 0",
                f"  on_radial_interface: "
                f"{'true' if spec['vector'] else 'false'}",
                f"  on_azimuthal_interface: "
                f"{'true' if name == 'vazi' else 'false'}",
                f"  filename: {name}.dat",
                "",
            ]
        (self.outdir / "info2D.yml").write_text("\n".join(lines))

    def _write_info1d(self):
        """info1D.yml: self-describing 1-D profile list (reference
        src/output.cpp:717-787 ``write_1D_info``). Layout per ring:
        [radius, azimuthal average, min, max] float64."""
        lines = ["# 1D output variable descriptions", "# version 0.1", ""]
        for name, spec in self._field_specs().items():
            lines += [
                f"{name}1D:",
                f"  cgs symbols: {spec['unit']}",
                f"  code_to_cgs_factor: {spec['factor']:.17g}",
                f"  Nrad: {spec['nrad']}",
                "  layout: radius value min max",
                "  bigendian: 0",
                f"  filename: {name}1D.dat",
                "",
            ]
        (self.outdir / "info1D.yml").write_text("\n".join(lines))

    def _write_info_particles(self):
        """infoParticles.yml (reference src/output.cpp:830-850): layout of
        the per-snapshot particles.bin records."""
        un = self.sim.units
        cols = [("r", "cm", un.length), ("phi", "1", 1.0),
                ("r dot", "cm s^-1", un.velocity),
                ("phi dot", "s^-1", 1.0 / un.time),
                ("size", "cm", un.length), ("stokes", "1", 1.0),
                ("alive", "1", 1.0),
                ("timestep", "s", un.time), ("facold", "1", 1.0)]
        lines = ["# particle output description", "# version 0.1",
                 "particles:", "  filename: particles.bin",
                 f"  record: {len(cols)} float64 per particle",
                 "  columns:"]
        for name, unit, fac in cols:
            lines.append(f"    - {{name: {name}, unit: {unit}, "
                         f"factor: {fac:.17g}}}")
        (self.outdir / "infoParticles.yml").write_text("\n".join(lines)
                                                       + "\n")

    # ------------------------------------------------------------------
    def _snapshot_tensors(self) -> dict:
        """Every tensor one snapshot writes, keyed by file base name (the
        scalars of misc.bin and the bodies under their own keys)."""
        import torch
        sim = self.sim
        phys, st, f, state = sim.phys, sim.stepper, sim.fields, sim.state
        out = {}
        if phys.write_density:
            out["Sigma"] = f.sigma
        if phys.write_velocity:
            out["vrad"] = f.vrad
            out["vazi"] = f.vaz
        if phys.write_energy:
            out["energy"] = f.energy
        with st.detached(state.pvte_guess):
            if phys.is_adiabatic:
                from .ops import eos
                pv = st.pvte_vals(f.sigma, f.energy)
                out["Temperature"] = eos.temperature(
                    phys, sim.constants, f.sigma, f.energy, None, pv)
                # aspect ratio = H / r, divided on the host in float64
                out["_scale_height"] = st.derived(f.sigma, f.energy)[2]
            # Q grids for bitwise-exact restart (reference
            # src/restart.cpp:73-90, written only when
            # BitwiseExactRestarting is on and the run is not locally
            # isothermal, src/output.cpp:259)
            if (phys.bitwise_exact_restarting or phys.write_qplus) \
                    and phys.is_adiabatic:
                out["Qplus"] = state.qplus
            if (phys.bitwise_exact_restarting or phys.write_qminus) \
                    and phys.is_adiabatic:
                out["Qminus"] = state.qminus
            # PVTE warm-start cache: pure solver state, stored only so a
            # restart replays the uninterrupted trajectory bit-for-bit
            if phys.bitwise_exact_restarting \
                    and state.pvte_guess is not None:
                out["PvteGeff"], out["PvteMu"] = state.pvte_guess
            if phys.write_radial_luminosity or phys.write_radial_dissipation:
                out["_dr"] = (st.g.rsup - st.g.rinf)[:, 0]
                out["_qminus"] = state.qminus
                out["_qplus"] = state.qplus
            for name in phys.snapshot_fields:
                if name == "Temperature" and phys.is_adiabatic:
                    continue                      # already written above
                out[name] = self._compute_field(name)
            if phys.write_torques and phys.calculate_disk:
                out["_torque_planet"] = self._planet_torque_profiles()
        acc = state.monitor_acc
        for attr in MONITOR_FILES:
            if getattr(acc, attr) is not None:
                out[f"_acc_{attr}"] = getattr(acc, attr)
        if acc.rof_mdot is not None:
            out["_rof_mdot"] = acc.rof_mdot
        nb = state.nbody
        out["_nbody"] = torch.stack([nb.x, nb.y, nb.vx, nb.vy, nb.mass],
                                    dim=1).to(torch.float64)
        out["_misc"] = torch.stack([
            t.to(torch.float64).reshape(()) for t in
            (sim.time, state.omega_frame, state.frame_angle, sim.last_dt)])
        if state.particles is not None:
            p = state.particles
            out["particles"] = torch.stack(
                [p.r, p.phi, p.r_dot, p.phi_dot, p.size, p.stokes,
                 p.alive.to(p.r.dtype), p.timestep, p.facold],
                dim=1).to(torch.float64)
        return out

    def write_snapshot(self, snapshot_id: str | None = None,
                       register: bool = True):
        """One snapshot directory; its tensors reach the host with one
        synchronise. Returns the bytes written; ``telemetry.SNAPSHOTS``
        keeps its record."""
        from . import telemetry
        with telemetry.snapshot() as rec:
            sim = self.sim
            sid = snapshot_id if snapshot_id is not None \
                else str(sim.n_snapshot)
            sdir = self.outdir / "snapshots" / sid
            if sdir.exists():
                shutil.rmtree(sdir)
            sdir.mkdir(parents=True)
            self.snapshot_dir = sdir

            # free-space precheck (reference src/output.cpp:120-146): one
            # snapshot is ~5 full float64 grids plus metadata
            need = 6 * 8 * sim.geometry.nrad * sim.geometry.naz
            free = shutil.disk_usage(self.outdir).free
            if free < 2 * need:
                raise OSError(
                    f"not enough disk space for a snapshot: {free} bytes "
                    f"free, need ~{2 * need}")

            with rec.part("to_host"):
                host = to_host(self._snapshot_tensors())
            with rec.part("dump"):
                self._dump(sdir, host)
            # drain the async queue so the snapshot is durable before the
            # registry names it
            with rec.part("flush"):
                self._awriter.flush()
            if self._awriter.errors:
                raise OSError(f"the snapshot writer failed "
                              f"{self._awriter.errors} times writing {sdir}")
            if register:
                with open(self.outdir / "snapshots" / "list.txt", "a") as fl:
                    fl.write(sid + "\n")
                self._write_time_snapshot(float(host["_misc"][0]))
            rec.bytes = sum(p.stat().st_size for p in sdir.iterdir())
        return rec.bytes

    def _dump(self, sdir: Path, host: dict) -> None:
        """The snapshot's files from its host copies ``host``: the grids
        through the background writer, the rest written here."""
        sim = self.sim
        w = self._awriter.write
        rmed = sim.geometry.rmed
        for name in ("Sigma", "vrad", "vazi", "energy", "Temperature",
                     "Qplus", "Qminus", "PvteGeff", "PvteMu"):
            if name in host:
                w(sdir / f"{name}.dat", host[name])

        # 1-D radial profiles: interleaved [radius, azi-avg, min, max]
        # per ring (reference src/polargrid.cpp:187-260 write1D)
        for name in ("Sigma", "vrad", "vazi", "energy"):
            if name in host:
                self._write_1d(sdir, name, host[name],
                               sim.geometry.ra if name == "vrad" else rmed)
        if "_dr" in host:
            # ring-integrated Q-/Q+ (reference src/quantities.cpp:720-770
            # calculate_radial_luminosity/dissipation: sum_phi Q Rmed dr
            # dphi), written in the common 1-D [radius, v, v, v] layout
            dr, dphi = host["_dr"], sim.geometry.dphi
            if sim.phys.write_radial_luminosity:
                lum = host["_qminus"].sum(axis=1) * rmed * dr * dphi
                self._write_1d(sdir, "Luminosity", lum[:, None], rmed)
            if sim.phys.write_radial_dissipation:
                dis = host["_qplus"].sum(axis=1) * rmed * dr * dphi
                self._write_1d(sdir, "Dissipation", dis[:, None], rmed)
        if sim.phys.is_adiabatic:
            self._write_1d(sdir, "Temperature", host["Temperature"], rmed)
            self._write_1d(sdir, "aspectratio",
                           host["_scale_height"] / rmed[:, None], rmed)

        # optional Write*-flag 2-D fields (reference
        # src/parameters.cpp:243-312 set_write table)
        for name in sim.phys.snapshot_fields:
            if name == "Temperature" and sim.phys.is_adiabatic:
                continue
            w(sdir / f"{name}.dat", host[name])
            self._write_1d(sdir, name, host[name], rmed)

        # the accumulated monitor grids, averaged over the interval, then
        # cleared (fargocpt_tpu/output.py:366-394)
        self._write_monitor_grids(sdir, host)

        # per-planet torque radial profiles (reference src/output.cpp:653-716
        # ``write_torques``): [radius, torque] rows
        for k, prof in enumerate(host.get("_torque_planet", ())):
            np.stack([rmed, prof], axis=1).astype(np.float64).tofile(
                sdir / f"torque_planet_1D_{k}.dat")

        self._write_misc(sdir, host["_misc"])
        host["_nbody"].tofile(sdir / "nbody.bin")
        # the Roche-lobe tracker (reference src/massflow_tracker.cpp
        # write_to_file: delta_mass, averaging_time, mdot)
        if "_rof_mdot" in host:
            np.asarray([0.0, sim.stepper.rof_averaging_time(),
                        float(host["_rof_mdot"])], np.float64).tofile(
                sdir / "massflow_tracker.bin")
        # dust particles (reference src/particles/particles.cpp:2176
        # ``write``: one binary record per particle per snapshot)
        if "particles" in host:
            w(sdir / "particles.bin", host["particles"])

        # config provenance per snapshot (reference src/output.cpp:249-304
        # copies config.yml into every snapshot directory)
        setup_copy = self.outdir / "parameters" / "setup.yml"
        if setup_copy.exists():
            shutil.copyfile(setup_copy, sdir / "config.yml")

    def _write_monitor_grids(self, sdir: Path, host: dict):
        """Each monitor grid that is on, divided as ``MONITOR_FILES``
        says, with its 1-D file; the state's grids are set to zero."""
        import torch
        sim = self.sim
        acc = sim.state.monitor_acc
        mt = sim.settings.monitor_timestep
        cleared = {}
        for attr, (fname, per_interval) in MONITOR_FILES.items():
            if f"_acc_{attr}" not in host:
                continue
            arr = host[f"_acc_{attr}"] / (
                sim.settings.n_monitor * mt if per_interval else mt)
            self._awriter.write(sdir / f"{fname}.dat", arr)
            self._write_1d(sdir, fname, arr, sim.geometry.rmed)
            cleared[attr] = torch.zeros_like(getattr(acc, attr))
        if cleared:
            sim.state = sim.state.replace(monitor_acc=acc.replace(**cleared))

    def _write_time_snapshot(self, time: float):
        """Append (snapshot number, monitor number, time) to
        snapshots/timeSnapshot.dat with the reference's exact header and
        row format (reference src/output.cpp:1010-1068
        ``write_snapshot_time``); the reference Loader reads snapshot
        times and monitor numbers from this file
        (python_module/fargocpt/data.py ``_load_snapshots``)."""
        sim = self.sim
        path = self.outdir / "snapshots" / "timeSnapshot.dat"
        if not path.exists():
            un = sim.units
            mt = sim.settings.monitor_timestep
            with open(path, "w") as f:
                f.write("# Time log for course output.\n"
                        "#version: 0.1\n"
                        "#variable: 0 | snapshot number | 1\n"
                        "#variable: 1 | monitor number | 1\n"
                        f"#variable: 2 | time | {un.time:.16e} s\n"
                        f"# One monitor_timestep is {mt:.18g} (code) and "
                        f"{mt * un.time:.18g} (cgs).\n"
                        "# Syntax: snapshot number <tab> monitor number "
                        "<tab> time (cgs)\n")
        with open(path, "a") as f:
            f.write(f"{sim.n_snapshot}\t{sim.n_monitor}\t{time:#.16e}\n")

    def _write_1d(self, sdir: Path, name: str, field2d: np.ndarray,
                  radius: np.ndarray):
        # global 1-D switch (reference parameters.cpp:242 DoWrite1DFiles)
        if not self.sim.phys.do_write_1d:
            return
        out = np.empty((field2d.shape[0], 4), np.float64)
        out[:, 0] = radius[:field2d.shape[0]]
        out[:, 1] = field2d.mean(axis=1)
        out[:, 2] = field2d.min(axis=1)
        out[:, 3] = field2d.max(axis=1)
        out.tofile(sdir / f"{name}1D.dat")

    def _write_misc(self, sdir: Path, misc: np.ndarray):
        """misc.bin from (time, omega_frame, frame_angle, last_dt)."""
        sim = self.sim
        time, omega_frame, frame_angle, last_dt = (float(v) for v in misc)
        blob = struct.pack(
            MISC_STRUCT, sim.n_snapshot, sim.n_monitor, time, omega_frame,
            frame_angle, last_dt, sim.n_hydro_iter)
        (sdir / "misc.bin").write_bytes(blob)

    # ------------------------------------------------------------------
    def _compute_field(self, name: str):
        """Optional 2-D diagnostic fields, computed at write time from the
        current state (reference caches these in t_data polar grids); call
        inside ``stepper.detached``."""
        import torch
        from .ops import eos, quantities as quant, sources
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        phys, constants, g = sim.phys, sim.constants, st.g

        def filled(value):
            # a Python float broadcasts as float64, a grid as itself
            if torch.is_tensor(value):
                return torch.broadcast_to(value, f.sigma.shape).contiguous()
            return torch.full(f.sigma.shape, value, dtype=torch.float64,
                              device=f.sigma.device)

        cs, press, h = st.derived(f.sigma, f.energy)
        pv = st.pvte_vals(f.sigma, f.energy)
        if name == "Temperature":
            return eos.temperature(phys, constants, f.sigma, f.energy,
                                   press, pv)
        if name == "SoundSpeed":
            return cs
        if name == "Pressure":
            return press
        if name == "ScaleHeight":
            return h
        if name == "Toomre":
            return quant.toomre_q(phys, constants, g, f.sigma, cs)
        if name in ("EccentricityX", "EccentricityY"):
            ex, ey = quant.eccentricity_vector(
                phys, constants, g, f.sigma, f.vrad, f.vaz,
                sim.state.omega_frame, sim.state.frame_angle,
                st.ops.cos_row[None, :], st.ops.sin_row[None, :])
            return ex if name == "EccentricityX" else ey
        if name == "Potential":
            return self._potential(h)
        if name == "Kappa":
            from .ops import opacity as opac
            temp = eos.temperature(phys, constants, f.sigma, f.energy,
                                   press, pv)
            rho_mid = f.sigma / (phys.density_factor * h)
            return opac.opacity(phys, sim.units, rho_mid, temp)
        if name == "TauCool":
            return f.energy / torch.clamp(sim.state.qminus, min=1e-300)
        if name == "Viscosity":
            return st.viscosity_grid(cs, h)
        if name == "DivV":
            return sources.divergence_v(g, f.vrad, f.vaz)
        if name == "PdivV":
            # (gamma_eff - 1) dt div(v) E per cell (reference
            # src/SourceEuler.cpp:978-998); uses the last hydro dt
            gam = pv[0] if pv is not None else phys.adiabatic_index
            return (gam - 1.0) * float(sim.last_dt) \
                * sources.divergence_v(g, f.vrad, f.vaz) * f.energy
        if name == "TReynolds":
            return quant.reynolds_stress(g, f.sigma, f.vrad, f.vaz)
        if name == "AlphaReynolds":
            t = quant.reynolds_stress(g, f.sigma, f.vrad, f.vaz)
            return quant.alpha_from_stress(t, f.sigma, cs)
        if name in ("TGravitational", "AlphaGrav"):
            if st.selfgravity is None:
                return torch.zeros_like(f.sigma)
            g_r, g_t = st.selfgravity.accelerations(f.sigma)
            t = quant.gravitational_stress(phys, constants, g, g_r, g_t)
            if name == "TGravitational":
                return t
            return quant.alpha_from_stress(t, f.sigma, cs)
        if name == "GammaEff":
            return filled(pv[0] if pv is not None else phys.adiabatic_index)
        if name == "Gamma1":
            return filled(pv[2] if pv is not None else phys.adiabatic_index)
        if name == "Mu":
            return filled(pv[1] if pv is not None else phys.mu)
        if name == "Alpha":
            return torch.full_like(f.sigma, phys.viscous_alpha)
        if name == "AspectRatio":
            return h * g.inv_rb
        if name in ("Tau", "tau_eff"):
            # vertical optical depth, or the effective one SubStep3 fills
            # with WriteVerticalOpticalDepth (reference src/compute.cpp:41-87,
            # src/SourceEuler.cpp:925)
            from .ops.energy import kappa_tau_eff
            temp = eos.temperature(phys, constants, f.sigma, f.energy,
                                   press if name == "Tau" else None, pv)
            _k, tau, tau_eff = kappa_tau_eff(phys, constants, sim.units,
                                             f.sigma, temp, h)
            return tau if name == "Tau" else tau_eff
        if name in ("SGAccelRad", "SGAccelAzi"):
            # self-gravity acceleration grids (reference src/data.cpp
            # SG_ACCEL_RAD/AZI, filled by selfgravity.cpp)
            if st.selfgravity is None:
                return torch.zeros_like(f.sigma)
            g_r, g_t = st.selfgravity.accelerations(f.sigma)
            return g_r if name == "SGAccelRad" else g_t
        if name == "visiblity":
            # the reference registers VISIBILITY (with this spelling,
            # src/data.cpp:262-263) but never fills it — zeros, as written
            # by the reference binary
            return torch.zeros_like(f.sigma)
        raise KeyError(f"unknown snapshot field {name!r}")

    def _planet_torque_profiles(self):
        """(N, NR): each body's gas torque summed over each ring, the
        smoothed point-mass force of every cell with the ramped mass
        (reference src/output.cpp:653-716; fargocpt_tpu/output.py:607-630)."""
        import torch
        from .ops import gravity
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        _, _, h = st.derived(f.sigma, f.energy)
        bodies = st.bodies_on_grid(sim.state.nbody, sim.time)
        dt = f.sigma.dtype
        bx, by = bodies.x.to(dt), bodies.y.to(dt)
        bm = bodies.mass.to(dt)
        cell_x, cell_y = st.cell_x, st.cell_y
        cellmass = st.g.surf * f.sigma
        profs = []
        for k in range(st.n_bodies):
            body_r = torch.sqrt(bx[k] ** 2 + by[k] ** 2)
            smooth = gravity.smoothing_length(sim.phys, h, k, body_r)
            dx = cell_x - bx[k]
            dy = cell_y - by[k]
            inv_d3 = (dx * dx + dy * dy + smooth * smooth) ** -1.5
            w = sim.constants.G * cellmass * inv_d3 * bm[k]
            torque = bx[k] * (w * dy) - by[k] * (w * dx)
            profs.append(torch.sum(torque, dim=-1))
        return torch.stack(profs).to(torch.float64)

    def _potential(self, h):
        """The bodies' potential on the grid without the indirect term."""
        import torch
        from .ops import gravity
        sim = self.sim
        st = sim.stepper
        zero = torch.zeros((), dtype=st.dtype, device=h.device)
        cell_x, cell_y = st.cell_x, st.cell_y
        return gravity.nbody_potential(
            sim.phys, sim.constants, st.g,
            st.bodies_on_grid(sim.state.nbody, sim.time),
            st.n_bodies, cell_x, cell_y, h, zero, zero)

    def write_lightcurves(self):
        """monitor/luminosity.dat + dissipation.dat: radial luminosity /
        dissipation binned into the configured radii
        (reference src/output.cpp:852-1000 ``write_lightcurves``)."""
        from .ops import quantities as quant
        sim = self.sim
        radii = sim.phys.lightcurves_radii
        if not radii:
            return
        st = sim.stepper
        host = to_host({
            "lum": quant.radial_luminosity(st.g, sim.state.qminus),
            "dis": quant.radial_dissipation(st.g, sim.state.qplus),
            "time": sim.time})
        lum1d, dis1d = host["lum"], host["dis"]
        rmed = sim.geometry.rmed
        nr = sim.geometry.nrad
        nbins = len(radii)
        lum = np.zeros(nbins)
        dis = np.zeros(nbins)
        b = 0
        for n in range(1, nr - 1):            # active rings
            while b < nbins - 1 and radii[b] < rmed[n]:
                b += 1
            lum[b] += lum1d[n]
            dis[b] += dis1d[n]
        time = float(host["time"])
        for fname, vals in (("luminosity.dat", lum),
                            ("dissipation.dat", dis)):
            path = self.outdir / "monitor" / fname
            if not path.exists():
                with open(path, "w") as fd:
                    fd.write("# time\t" + fname.split(".")[0] + "\n")
            with open(path, "a") as fd:
                fd.write("\t".join([f"{time:.18g}"]
                                   + [f"{v:.18g}" for v in vals]) + "\n")

    def write_quantities(self):
        import torch
        sim = self.sim
        path = self.outdir / "monitor" / "Quantities.dat"
        if not self._quantities_initialized:
            if not path.exists():
                with open(path, "w") as f:
                    f.write("#FargoCPT quantities file\n")
                    f.write("#version: 2.4\n")
                    for i, name in enumerate(QUANTITIES_COLUMNS):
                        f.write(f"#variable: {i} | {name} | code units\n")
            self._quantities_initialized = True

        vals = self._compute_quantities()
        acc = sim.state.monitor_acc
        names = list(vals)
        flat = torch.cat([torch.stack([vals[n].reshape(()).to(torch.float64)
                                       for n in names]),
                          sim.state.frame_angle.reshape(1).to(torch.float64),
                          sim.time.reshape(1).to(torch.float64),
                          acc.mass_delta.to(torch.float64)])
        host = to_host({"flat": flat})["flat"].tolist()
        row = [0.0] * len(QUANTITIES_COLUMNS)
        row[0] = sim.n_snapshot
        row[1] = sim.n_monitor
        row[2] = host[len(names) + 1]
        for name, v in zip(names, host):
            row[QUANTITIES_COLUMNS.index(name)] = v
        row[QUANTITIES_COLUMNS.index("frame angle")] = host[len(names)]
        # boundary/damping/floor mass bookkeeping accumulated per step
        # (reference src/output.cpp:438-490 + src/types.h:30-60), reset
        # after each monitor write
        for name, v in zip(MASS_DELTA_COLUMNS, host[len(names) + 2:]):
            row[QUANTITIES_COLUMNS.index(name)] = v
        sim.state = sim.state.replace(monitor_acc=acc.replace(
            mass_delta=torch.zeros_like(acc.mass_delta)))
        with open(path, "a") as f:
            f.write("\t".join(f"{v:.18g}" for v in row) + "\n")

    def _quantities_radius_limit(self) -> float:
        """Integration radius for the Quantities.dat scalars (reference
        src/parameters.cpp:549-556 + src/output.cpp:367-374): default
        2*RMAX; values <= RMIN reset to the default at parse time;
        negative means the primary's Roche lobe about the secondary."""
        sim = self.sim
        qrl = sim.phys.quantities_radius_limit
        if qrl == 0.0:
            return 2.0 * sim.geometry.rmax
        if 0.0 < qrl <= sim.geometry.rmin:
            return 2.0 * sim.geometry.rmax
        if qrl < 0.0:
            # the primary's Roche lobe about the secondary; a lone star has
            # no secondary
            nb = sim.state.nbody
            if nb.n < 2:
                return 2.0 * sim.geometry.rmax
            import torch
            from .nbody import system as nbody_sys
            # the L1 Newton with the roles swapped: body 1 plays the centre
            swapped = nb.replace(x=nb.x[[1, 0]], y=nb.y[[1, 0]],
                                 vx=nb.vx[:2], vy=nb.vy[:2],
                                 mass=nb.mass[[1, 0]])
            frac = nbody_sys.dimensionless_roche_radius(swapped)[1]
            dist = torch.hypot(nb.x[1] - nb.x[0], nb.y[1] - nb.y[0])
            from . import telemetry
            telemetry.count("sync.monitor.radius_limit")
            return float(frac * dist)
        return float(qrl)

    def _compute_quantities(self) -> dict:
        """The Quantities.dat scalars as 0-d tensors on the run device."""
        import torch
        from .ops import quantities as quant, sources
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        g = st.g
        radius_limit = self._quantities_radius_limit()
        with st.detached(sim.state.pvte_guess):
            cs, _, h = st.derived(f.sigma, f.energy)
            pot = self._potential(h)
            vals = quant.monitor_quantities(
                sim.phys, sim.constants, g, f.sigma, f.vrad, f.vaz, f.energy,
                pot, sim.state.qplus, sim.state.qminus,
                sim.state.omega_frame, sim.state.frame_angle,
                st.ops.cos_row[None, :], st.ops.sin_row[None, :],
                radius_limit)
            # instantaneous disk torques (reference
            # src/quantities.cpp:1000-1017
            # CalculateMonitorQuantitiesForOutput, dt = 1)
            nr = g.nrad
            mask = g.rb[1:nr - 1] <= radius_limit

            def reduce_active(grid):
                return torch.sum(torch.where(mask, grid[1:nr - 1], 0.0))

            nu = st.viscosity_grid(cs, h)
            vals["advection torque"] = reduce_active(
                quant.advection_torque_increment(g, f.sigma, f.vrad, f.vaz,
                                                 1.0))
            vals["viscous torque"] = reduce_active(
                quant.viscous_torque_increment(g, f.sigma, nu, f.vrad, f.vaz,
                                               1.0))
            vals["gravitational torque"] = reduce_active(
                quant.gravitational_torque_increment(g, f.sigma, pot, 1.0))
            # pdivv of the last hydro step (reference
            # src/SourceEuler.cpp:978 + output.cpp:425-466)
            if sim.phys.is_adiabatic:
                pv = st.pvte_vals(f.sigma, f.energy)
                gam = pv[0] if pv is not None else sim.phys.adiabatic_index
                from . import telemetry
                telemetry.count("sync.monitor.pdivv_dt")
                pdivv = (gam - 1.0) * float(sim.last_dt) \
                    * sources.divergence_v(g, f.vrad, f.vaz) * f.energy
                vals["pdivv"] = reduce_active(pdivv)
        return vals

    def write_timestep_log(self):
        sim = self.sim
        st = sim.monitor_stats
        if not st:
            return
        path = self.outdir / "monitor" / "timestepLogging.dat"
        if not path.exists():
            with open(path, "w") as f:
                f.write("# timestep logging file\n")
                f.write("#variable: 0 | snapshot number | 1\n")
                f.write("#variable: 1 | monitor number | 1\n")
                f.write("#variable: 2 | time | code\n")
                f.write("#variable: 3 | walltime | s\n")
                f.write("#variable: 4 | walltime per hydrostep | ms\n")
                f.write("#variable: 5 | mean dt | code\n")
                f.write("#variable: 6 | min dt | code\n")
                f.write("#variable: 7 | std dev dt | code\n")
        n = max(st["n_steps"], 1)
        mean = st["dt_sum"] / n
        var = max(st["dt_sq"] / n - mean ** 2, 0.0)
        from . import telemetry
        telemetry.count("sync.monitor.time")
        with open(path, "a") as f:
            f.write(f"{sim.n_snapshot}\t{sim.n_monitor}\t"
                    f"{float(sim.time):.18g}\t"
                    f"{st['walltime']:.6g}\t"
                    f"{1e3 * st['walltime'] / n:.6g}\t"
                    f"{mean:.18g}\t{st['dt_min']:.18g}\t"
                    f"{math.sqrt(var):.18g}\n")

    def write_nbody_monitor(self):
        import torch
        sim = self.sim
        st = sim.stepper
        nb = sim.state.nbody
        extra = {"time": sim.time.to(torch.float64),
                 "omega_frame": sim.state.omega_frame.to(torch.float64)}
        if sim.phys.calculate_disk:
            from .nbody import system as nbody_sys
            from .ops import quantities as quant
            with st.detached(sim.state.pvte_guess):
                extra["torque"] = st.disk_torques(sim.state, sim.time)
            # the circumplanetary (Roche-lobe) gas mass of each companion
            # (reference src/circumplanetary_mass.cpp:11-50)
            if nb.n > 1:
                roche = nbody_sys.dimensionless_roche_radius(nb) \
                    * nbody_sys.dist_to_primary(nb)
                cell_x, cell_y = st.cell_x, st.cell_y
                dt = sim.fields.sigma.dtype
                extra["mdcp"] = torch.stack([
                    torch.zeros((), dtype=dt, device=nb.x.device)] + [
                    quant.circumplanetary_mass(
                        sim.constants, st.g, sim.fields.sigma, cell_x,
                        cell_y, nb.x[k].to(dt), nb.y[k].to(dt),
                        roche[k].to(dt)) for k in range(1, nb.n)])
        host = to_host({"bodies": torch.stack(
            [nb.x, nb.y, nb.vx, nb.vy, nb.mass]).to(torch.float64),
            **extra})
        time = float(host["time"])
        omega_frame = float(host["omega_frame"])
        for k in range(nb.n):
            path = self.outdir / "monitor" / f"nbody{k}.dat"
            new = not path.exists()
            el = sim.orbital_elements(k)
            torque = float(host["torque"][k]) if "torque" in host else 0.0
            mdcp = float(host["mdcp"][k]) if "mdcp" in host else 0.0
            with open(path, "a") as f:
                if new:
                    cols = ["snapshot number", "monitor number", "x", "y",
                            "vx", "vy", "mass", "time", "omega frame",
                            "mdcp", "eccentricity", "angular momentum",
                            "semi-major axis", "omega kepler", "mean anomaly",
                            "eccentric anomaly", "true anomaly",
                            "pericenter angle", "torque", "accreted mass",
                            "indirect torque"]
                    f.write("#FargoCPT planet file\n#version: 2.1\n")
                    for i, c in enumerate(cols):
                        f.write(f"#variable: {i} | {c} | code units\n")
                x, y, vx, vy, m = (float(v) for v in host["bodies"][:, k])
                L = m * (x * vy - y * vx)
                omega_k = math.sqrt(
                    sim.constants.G * sim.phys.hydro_center_mass
                    / max(el["a"], 1e-300) ** 3) if el["a"] > 0 else 0.0
                # accreted mass = growth over the configured mass (the
                # reference tracks it separately; with disk feedback on
                # the two are identical, reference accretion.cpp:205-218)
                accreted = m - float(sim.bodies[k].mass)
                f.write("\t".join(f"{v:.18g}" for v in [
                    sim.n_snapshot, sim.n_monitor, x, y, vx, vy, m, time,
                    omega_frame, mdcp, el["e"], L, el["a"],
                    omega_k, el["mean_anomaly"], el["eccentric_anomaly"],
                    el["true_anomaly"], el["pericenter_angle"], torque,
                    accreted, 0.0]) + "\n")

    def write_ecc_changes(self):
        """monitor/eccentricity_change.dat: the disk's eccentricity and
        pericentre changes of each stage over the interval (reference
        src/output.cpp:1275-1372 ``write_ecc_peri_changes``;
        fargocpt_tpu/output.py:707-740), then set to zero."""
        import torch
        sim = self.sim
        acc = sim.state.monitor_acc
        path = self.outdir / "monitor" / "eccentricity_change.dat"
        if not path.exists():
            with open(path, "w") as f:
                f.write("# Per-stage disk ecc/pericenter changes\n")
                cols = ["snapshot number", "monitor number", "time"] + [
                    f"{q} change {stage}" for q in ("ecc", "peri")
                    for stage in ECC_STAGES]
                for i, c in enumerate(cols):
                    f.write(f"#variable: {i} | {c} | code units\n")
        host = to_host({"decc": acc.decc, "dperi": acc.dperi,
                        "time": sim.time.to(torch.float64)})
        with open(path, "a") as f:
            f.write("\t".join(
                [str(sim.n_snapshot), str(sim.n_monitor),
                 f"{float(host['time']):.16e}"]
                + [f"{v:.16e}" for v in host["decc"]]
                + [f"{v:.16e}" for v in host["dperi"]]) + "\n")
        sim.state = sim.state.replace(monitor_acc=acc.replace(
            decc=torch.zeros_like(acc.decc),
            dperi=torch.zeros_like(acc.dperi)))

    # hooks ---------------------------------------------------------------
    def _on_monitor(self, sim):
        from . import telemetry
        with telemetry.span("output.monitor"):
            if sim.phys.write_disk_quantities:
                self.write_quantities()
            self.write_timestep_log()
            self.write_nbody_monitor()
            if sim.phys.write_lightcurves:
                self.write_lightcurves()
            if sim.phys.write_ecc_changes:
                self.write_ecc_changes()

    def _on_snapshot(self, sim):
        self.write_snapshot()

    def close(self):
        """Drain and stop the background writer."""
        self._awriter.close()


# ---------------------------------------------------------------------------
# a sharded run's snapshot (DistributedOutput)
# ---------------------------------------------------------------------------

_ROW_GRIDS = ("Sigma", "vrad", "vazi", "energy", "Temperature", "Qplus",
              "Qminus", "PvteGeff", "PvteMu")


def write_sharded_snapshot(sim, ss, local, outdir, writer=None):
    """One snapshot of a run sharded over ``ss.comm``'s ranks with
    DistributedOutput (fargocpt_tpu/output.py:254-275): every rank writes
    the rows it owns of each grid as row files (v_rad's top face with the
    top rank's rows), never gathered; rank 0 (``writer``, its
    ``OutputWriter``) the 1-D files from the ranks' per-ring mean, min and
    max, misc.bin, nbody.bin and config.yml, and registers the snapshot.
    ``local`` is the rank's window state. Every rank calls it."""
    import torch
    from .ops import eos
    comm, phys = ss.comm, sim.phys
    sdir = Path(outdir) / "snapshots" / str(sim.n_snapshot)
    if comm.rank == 0:
        if sdir.exists():
            shutil.rmtree(sdir)
        sdir.mkdir(parents=True)
    comm.barrier()
    f, ws, own, Lx = local.fields, ss.window, ss._own, ss.Lx
    grids = {}
    if phys.write_density:
        grids["Sigma"] = f.sigma
    if phys.write_velocity:
        grids["vrad"], grids["vazi"] = f.vrad, f.vaz
    if phys.write_energy:
        grids["energy"] = f.energy
    with ws.detached(local.pvte_guess):
        if phys.is_adiabatic:
            pv = ws.pvte_vals(f.sigma, f.energy)
            grids["Temperature"] = eos.temperature(
                phys, sim.constants, f.sigma, f.energy, None, pv)
            grids["_scale_height"] = ws.derived(f.sigma, f.energy)[2]
    if phys.is_adiabatic and (phys.bitwise_exact_restarting
                              or phys.write_qplus):
        grids["Qplus"] = local.qplus
    if phys.is_adiabatic and (phys.bitwise_exact_restarting
                              or phys.write_qminus):
        grids["Qminus"] = local.qminus
    if phys.bitwise_exact_restarting and local.pvte_guess is not None:
        grids["PvteGeff"], grids["PvteMu"] = local.pvte_guess
    owned = {name: own(x) for name, x in grids.items()}
    if ss.is_top and "vrad" in owned:
        owned["vrad"] = torch.cat([owned["vrad"], f.vrad[Lx:Lx + 1]])
    host = to_host(owned)
    row0 = ss.rank * ss.L
    for name in _ROW_GRIDS:
        if name in host:
            write_rows(host[name], row0, sdir, name)

    if phys.do_write_1d:
        g = sim.geometry
        rmed = g.rmed[row0:row0 + ss.L]
        one_d = [(name, host[name], g.ra if name == "vrad" else g.rmed)
                 for name in ("Sigma", "vrad", "vazi", "energy")
                 if name in host]
        if phys.is_adiabatic:
            one_d += [("Temperature", host["Temperature"], g.rmed),
                      ("aspectratio",
                       host["_scale_height"] / rmed[:, None], g.rmed)]
        # (L + 1, F, 3): each grid's per-ring statistics as the serial
        # writer takes them; row L holds the top face of v_rad
        stats = np.zeros((ss.L + 1, len(one_d), 3), np.float64)
        for j, (_, arr, _) in enumerate(one_d):
            m = arr.shape[0]
            stats[:m, j, 0] = arr.mean(axis=1)
            stats[:m, j, 1] = arr.min(axis=1)
            stats[:m, j, 2] = arr.max(axis=1)
        every = comm.gather_rows(torch.tensor(
            stats, device=comm.device)).cpu().numpy()
        if comm.rank == 0:
            every = every.reshape(ss.n, ss.L + 1, len(one_d), 3)
            for j, (name, _, radius) in enumerate(one_d):
                rows = [every[r, :ss.L, j] for r in range(ss.n)]
                if name == "vrad":
                    rows.append(every[ss.n - 1, ss.L:, j])
                st = np.concatenate(rows)
                out = np.empty((st.shape[0], 4), np.float64)
                out[:, 0] = radius[:st.shape[0]]
                out[:, 1:] = st
                out.tofile(sdir / f"{name}1D.dat")

    if comm.rank == 0:
        nb = local.nbody
        misc = to_host({"misc": torch.stack([
            t.to(torch.float64).reshape(()) for t in
            (sim.time, local.omega_frame, local.frame_angle, sim.last_dt)]),
            "nbody": torch.stack([nb.x, nb.y, nb.vx, nb.vy, nb.mass],
                                 dim=1).to(torch.float64)})
        writer._write_misc(sdir, misc["misc"])
        misc["nbody"].tofile(sdir / "nbody.bin")
        setup_copy = Path(outdir) / "parameters" / "setup.yml"
        if setup_copy.exists():
            shutil.copyfile(setup_copy, sdir / "config.yml")
    comm.barrier()
    if comm.rank == 0:
        with open(Path(outdir) / "snapshots" / "list.txt", "a") as fl:
            fl.write(f"{sim.n_snapshot}\n")
        writer._write_time_snapshot(float(misc["misc"][0]))


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------

_ROW_FILE = re.compile(r"^(.+)\.r(\d+)-(\d+)\.dat$")


def write_rows(arr: np.ndarray, row0: int, sdir: Path, base: str) -> None:
    """A sharded run's rows ``[row0, row0 + len(arr))`` of a grid as
    ``<base>.r<start>-<stop>.dat``, float64 (the JAX package's
    ``write_sharded_array``, fargocpt_tpu/output.py:953-969)."""
    row1 = row0 + arr.shape[0]
    np.asarray(arr, np.float64).tofile(
        Path(sdir) / f"{base}.r{row0:05d}-{row1:05d}.dat")


def row_files(sdir: Path, base: str) -> list[tuple[int, int, Path]]:
    """The (start, stop, path) of each row file of ``base``."""
    out = []
    for p in sorted(Path(sdir).glob(f"{base}.r*-*.dat")):
        m = _ROW_FILE.match(p.name)
        if m and m.group(1) == base:
            out.append((int(m.group(2)), int(m.group(3)), p))
    return out


def read_rows(sdir: Path, base: str, shape, rows=None) -> np.ndarray:
    """Rows ``[start, stop)`` (all where ``rows`` is None) of a grid of
    ``shape`` from its row files, whatever rank count wrote them
    (fargocpt_tpu/output.py:972-1000); raises where they leave a row
    out."""
    pieces = row_files(sdir, base)
    if not pieces:
        raise FileNotFoundError(f"no row files of {base} in {sdir}")
    r0, r1 = rows if rows is not None else (0, shape[0])
    tail = tuple(shape[1:])
    out = np.empty((r1 - r0,) + tail, np.float64)
    filled = 0
    for f0, f1, path in pieces:
        lo, hi = max(r0, f0), min(r1, f1)
        if lo >= hi:
            continue
        data = np.fromfile(path, np.float64).reshape((f1 - f0,) + tail)
        out[lo - r0:hi - r0] = data[lo - f0:hi - f0]
        filled += hi - lo
    if filled < r1 - r0:
        raise ValueError(f"the row files of {base} do not cover rows "
                         f"{r0}:{r1}")
    return out


def load_misc(snapshot_dir: str | Path) -> dict:
    blob = (Path(snapshot_dir) / "misc.bin").read_bytes()
    vals = struct.unpack(MISC_STRUCT, blob[:struct.calcsize(MISC_STRUCT)])
    return {"n_snapshot": vals[0], "n_monitor": vals[1], "time": vals[2],
            "omega_frame": vals[3], "frame_angle": vals[4],
            "last_dt": vals[5], "n_hydro_iter": vals[6]}


def last_snapshot_id(outdir: str | Path) -> str:
    path = Path(outdir) / "snapshots" / "list.txt"
    ids = [l.strip() for l in path.read_text().splitlines() if l.strip()]
    return ids[-1]


def restore_simulation(sim, outdir: str | Path, snapshot_id: str | int):
    """Load a snapshot back into a freshly constructed Simulation
    (reference src/restart.cpp:19-131): the tensors are rebuilt in the run
    dtype on the run device (the bodies in float64), so a snapshot of the
    same dtype restores bit for bit."""
    import torch
    sdir = Path(outdir) / "snapshots" / str(snapshot_id)
    g = sim.geometry
    dt, dev = sim.dtype, sim.device

    def have(base):
        return (sdir / f"{base}.dat").exists() or bool(row_files(sdir, base))

    def rd(base, nrad, dtype=dt):
        # a sharded run's row files, whatever the writer's rank count,
        # make the same array (fargocpt_tpu/output.py:1013-1031)
        if (sdir / f"{base}.dat").exists():
            arr = np.fromfile(sdir / f"{base}.dat", np.float64)
        else:
            arr = read_rows(sdir, base, (nrad, g.naz))
        return torch.tensor(arr.reshape(nrad, g.naz), dtype=dtype,
                            device=dev)

    def scalar(value, dtype=dt):
        return torch.tensor(value, dtype=dtype, device=dev)

    state = sim.state
    fields = state.fields.replace(
        sigma=rd("Sigma", g.nrad), vrad=rd("vrad", g.nrad + 1),
        vaz=rd("vazi", g.nrad), energy=rd("energy", g.nrad))
    misc = load_misc(sdir)
    nb_arr = np.fromfile(sdir / "nbody.bin", np.float64).reshape(-1, 5)
    nbody = state.nbody.replace(**{
        name: torch.tensor(nb_arr[:, k], dtype=torch.float64, device=dev)
        for k, name in enumerate(("x", "y", "vx", "vy", "mass"))})
    qplus = rd("Qplus", g.nrad) if have("Qplus") else state.qplus
    qminus = rd("Qminus", g.nrad) if have("Qminus") else state.qminus
    # dust particles (reference src/particles/particles.cpp:797 restart)
    particles = state.particles
    if (sdir / "particles.bin").exists() and particles is not None:
        raw = np.fromfile(sdir / "particles.bin", np.float64)
        ncol = 9 if raw.size % 9 == 0 else 7   # 7 = pre-round-2 snapshots
        arr = raw.reshape(-1, ncol)
        n = arr.shape[0]

        def col(k):
            return torch.tensor(arr[:, k], dtype=dt, device=dev)
        particles = particles.replace(
            r=col(0), phi=col(1), r_dot=col(2), phi_dot=col(3), size=col(4),
            stokes=col(5),
            alive=torch.tensor(arr[:, 6] > 0.5, device=dev),
            timestep=col(7) if ncol == 9
            else torch.zeros(n, dtype=dt, device=dev),
            facold=col(8) if ncol == 9
            else torch.full((n,), 1e-4, dtype=dt, device=dev))
    # the Roche-lobe tracker (reference src/massflow_tracker.cpp
    # read_from_file)
    monitor_acc = state.monitor_acc
    if (sdir / "massflow_tracker.bin").exists() \
            and monitor_acc.rof_mdot is not None:
        vals = np.fromfile(sdir / "massflow_tracker.bin", np.float64)
        monitor_acc = monitor_acc.replace(rof_mdot=scalar(vals[2]))
    pvte_guess = state.pvte_guess
    if pvte_guess is not None:
        if have("PvteGeff") and have("PvteMu"):
            # exact warm-start cache from the snapshot: the restarted
            # trajectory is bitwise the uninterrupted one
            pvte_guess = (rd("PvteGeff", g.nrad), rd("PvteMu", g.nrad))
        else:
            # no cache in the snapshot: re-seed with a cold solve on the
            # RESTORED fields (a pure solver cache — tolerance-level
            # difference only)
            with sim.stepper.detached(None):
                pv = sim.stepper.pvte_vals(fields.sigma, fields.energy)
            pvte_guess = (pv[0], pv[1])
    sim.state = state.replace(
        fields=fields, nbody=nbody, qplus=qplus, qminus=qminus,
        omega_frame=scalar(misc["omega_frame"]),
        frame_angle=scalar(misc["frame_angle"]),
        monitor_acc=monitor_acc, pvte_guess=pvte_guess,
        particles=particles)
    sim.time = scalar(misc["time"])
    sim.last_dt = scalar(misc["last_dt"])
    sim.n_monitor = misc["n_monitor"]
    sim.n_snapshot = misc["n_snapshot"]
    sim.n_hydro_iter = misc["n_hydro_iter"]
    # restarts resume with the stored last_dt; the fresh-start double
    # growth (Simulation.begin) must not apply (reference
    # src/simulation.cpp:467)
    sim._dt_primed = True
    # the reference never re-writes the restored snapshot on restart
    # (src/simulation.cpp:505-560 run() has no initial handle_outputs);
    # re-registering it would duplicate list.txt / timeSnapshot.dat rows
    sim._restored = True
    return sim

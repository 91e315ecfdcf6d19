"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/fargo_plain``), number by number.

Three readings of a run, each with its limit from the cell's file:

* ``start_gap``: the state at the window's start. The reference builds
  its own initial conditions from the configuration, takes the same
  seeded perturbation and the same warm-up steps, and its fields are
  compared with the program's.
* ``end_gap``: the window's last call. The reference takes the program's
  state before that call (the one stretch where it follows the program's
  own state: it cannot afford the window's thousands of steps) and makes
  the same call; its fields are compared with the program's result.
* ``time_gap``: the simulated time at both points; ``swarm_gap``: the
  dust particles at both points, where the run has a swarm;
  ``snap_gap``: a snapshot written inside the window, drawn from the
  seed, read back from its files and compared with the state it was
  written from (the fields, the temperature the reference derives from
  them, the time).

A gap is the largest difference over a field divided by the largest
magnitude of the reference's field. The angle of a particle is compared
on the circle, as a share of pi.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

FIELDS = ("sigma", "vrad", "vaz", "energy")


@dataclasses.dataclass
class GenState:
    """A ``torch.Generator`` carried to the host: its device and state."""
    device: str
    state: torch.Tensor


def to_host(obj):
    """A copy of the program's state on the host: the same dataclasses,
    tensors copied to the CPU, generators kept as their state."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, torch.Generator):
        return GenState(str(obj.device), obj.get_state())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def reference_classes() -> dict:
    from .reference.fargo_plain import state
    from .reference.fargo_plain.nbody import system
    from .reference.fargo_plain.particles import dust
    return {c.__name__: c for c in (
        state.FieldState, state.SystemState, state.MonitorAccum,
        dust.ParticleState, system.NBodyState)}


def to_reference(obj, classes: dict, device, dtype: torch.dtype):
    """A host copy of the program's state as the reference's state on
    ``device``, its floating tensors in ``dtype``."""
    if torch.is_tensor(obj):
        t = obj.to(device)
        if t.is_complex():
            t = t.to(torch.complex128 if dtype == torch.float64
                     else torch.complex64)
        elif t.is_floating_point():
            t = t.to(dtype)
        return t.clone()
    if isinstance(obj, GenState):
        g = torch.Generator(device=device)
        if torch.device(obj.device).type == torch.device(device).type:
            g.set_state(obj.state)
        return g
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes[type(obj).__name__]
        return cls(**{f.name: to_reference(getattr(obj, f.name), classes,
                                           device, dtype)
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_reference(v, classes, device, dtype)
                         for v in obj)
    return obj


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| in float64 (b the reference); NaN where either
    is not finite."""
    a = a.to(torch.float64).cpu()
    b = b.to(torch.float64).cpu()
    if a.shape != b.shape:
        return math.inf
    if b.numel() == 0:
        return 0.0
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.nan
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale > 0 else diff


def fields_gap(prog_fields, ref_fields) -> float:
    return max(rel_gap(getattr(prog_fields, k), getattr(ref_fields, k))
               for k in FIELDS)


def swarm_gap(p, r) -> float:
    """The particles' r, r_dot, phi_dot against the reference's, phi on the
    circle as a share of pi; 1 where a particle lives on one side only."""
    if p is None and r is None:
        return 0.0
    alive_p, alive_r = p.alive.cpu(), r.alive.cpu()
    if not torch.equal(alive_p, alive_r):
        return 1.0
    gaps = [rel_gap(getattr(p, k).cpu()[alive_r], getattr(r, k).cpu()[alive_r])
            for k in ("r", "r_dot", "phi_dot")]
    dphi = torch.remainder(p.phi.cpu().double()[alive_r]
                           - r.phi.cpu().double()[alive_r] + math.pi,
                           2.0 * math.pi) - math.pi
    gaps.append(float(dphi.abs().max()) / math.pi if dphi.numel() else 0.0)
    return max(gaps)


def time_gap(t_prog, t_ref) -> float:
    tp, tr = float(t_prog), float(t_ref)
    if not (math.isfinite(tp) and math.isfinite(tr)):
        return math.nan
    return abs(tp - tr) / abs(tr) if tr else abs(tp - tr)


def read_snapshot(sdir: Path, nr: int, naz: int) -> dict:
    """The fields, the temperature and the time of a snapshot directory of
    the port's layout: raw little-endian float64 grids, (NR, NAZ) and
    (NR + 1, NAZ) for v_rad; misc.bin's struct '=IIddddQ' whose first
    double is the time."""
    def grid(name, rows):
        return np.fromfile(sdir / f"{name}.dat", dtype="<f8").reshape(
            rows, naz)
    misc = np.fromfile(sdir / "misc.bin", dtype=np.uint8)
    time = float(np.frombuffer(misc[8:16].tobytes(), dtype="<f8")[0])
    return {"sigma": grid("Sigma", nr), "vrad": grid("vrad", nr + 1),
            "vaz": grid("vazi", nr), "energy": grid("energy", nr),
            "temperature": grid("Temperature", nr), "time": time}


def snapshot_gap(files: dict, kept: dict, ref_sim) -> float:
    """The snapshot's files against the state they were written from: the
    four fields, the temperature the reference derives from that state
    with its own equation of state, the time."""
    from .reference.fargo_plain.ops import eos
    dev = ref_sim.device
    f = {k: kept[k].to(dev, torch.float64) for k in FIELDS}
    pv = ref_sim.stepper.pvte_vals(f["sigma"], f["energy"]) \
        if ref_sim.stepper.pvte is not None else None
    temp = eos.temperature(ref_sim.phys, ref_sim.constants, f["sigma"],
                           f["energy"], None, pv)
    gaps = [rel_gap(torch.from_numpy(files[k]), f[k]) for k in FIELDS]
    gaps.append(rel_gap(torch.from_numpy(files["temperature"]), temp))
    gaps.append(time_gap(files["time"], kept["time"]))
    return max(gaps)

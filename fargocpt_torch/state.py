"""Simulation state: plain dataclasses of tensors with ``.replace()``.

Shapes:
  * sigma, energy, vaz, qplus, qminus: (NR, NAZ) — ring 0 / NR-1 ghost
  * vrad:                              (NR+1, NAZ) — radial faces
  * nbody.*: (N_bodies,) float64; omega_frame, frame_angle: 0-d

``system_state_from_numpy`` / ``system_state_to_numpy`` carry a state
across packages as a flat dict of numpy arrays keyed by dotted names
(``"fields.sigma"``, ``"nbody.x"``, ``"monitor_acc.mass_delta"``, ...),
so a run can start from another implementation's state.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields, replace

import numpy as np
import torch

from .nbody.system import NBodyState


@dataclass(frozen=True)
class FieldState:
    sigma: torch.Tensor
    vrad: torch.Tensor
    vaz: torch.Tensor
    energy: torch.Tensor

    def replace(self, **kw) -> "FieldState":
        return replace(self, **kw)


# indices into MonitorAccum.mass_delta (reference src/types.h:30-60)
MD_INNER_IN, MD_INNER_OUT, MD_OUTER_IN, MD_OUTER_OUT = 0, 1, 2, 3
MD_DAMP_IN_CREATE, MD_DAMP_IN_REMOVE = 4, 5
MD_DAMP_OUT_CREATE, MD_DAMP_OUT_REMOVE = 6, 7
MD_FLOOR_CREATE = 8
N_MASS_DELTA = 9


@dataclass(frozen=True)
class MonitorAccum:
    """Per-step accumulated monitor values. Only the always-tracked mass
    bookkeeping (reference src/types.h:30-60 BoundaryFlow) is ported."""
    mass_delta: torch.Tensor

    def replace(self, **kw) -> "MonitorAccum":
        return replace(self, **kw)


@dataclass(frozen=True)
class SystemState:
    """Complete per-run dynamic state carried through the time loop."""
    fields: FieldState
    qplus: torch.Tensor
    qminus: torch.Tensor
    nbody: NBodyState
    omega_frame: torch.Tensor
    frame_angle: torch.Tensor
    corot_ref_x: torch.Tensor
    corot_ref_y: torch.Tensor
    monitor_acc: MonitorAccum

    def replace(self, **kw) -> "SystemState":
        return replace(self, **kw)


_GROUPS = {"fields": FieldState, "nbody": NBodyState,
           "monitor_acc": MonitorAccum}
_NBODY_KEYS = {"nbody.x", "nbody.y", "nbody.vx", "nbody.vy", "nbody.mass",
               "corot_ref_x", "corot_ref_y"}


def state_keys() -> list[str]:
    """The dotted names of every tensor of a ``SystemState``."""
    keys = []
    for f in dc_fields(SystemState):
        group = _GROUPS.get(f.name)
        if group is None:
            keys.append(f.name)
        else:
            keys.extend(f"{f.name}.{g.name}" for g in dc_fields(group))
    return keys


def system_state_from_numpy(tree: dict[str, np.ndarray],
                            device: torch.device | str,
                            dtype: torch.dtype) -> SystemState:
    """Build a ``SystemState`` on ``device`` from a flat numpy dict. Field
    and scalar entries take ``dtype``; body entries are float64."""
    missing = set(state_keys()) - set(tree)
    if missing:
        raise KeyError(f"state dict lacks {sorted(missing)}")

    def t(key):
        dt = torch.float64 if key in _NBODY_KEYS else dtype
        return torch.tensor(np.asarray(tree[key]), dtype=dt, device=device)

    parts = {}
    for f in dc_fields(SystemState):
        group = _GROUPS.get(f.name)
        if group is None:
            parts[f.name] = t(f.name)
        else:
            parts[f.name] = group(**{g.name: t(f"{f.name}.{g.name}")
                                     for g in dc_fields(group)})
    return SystemState(**parts)


def state_tensors(state: SystemState) -> dict[str, torch.Tensor]:
    """Flat dict of every tensor in ``state`` (no copies)."""
    out = {}
    for f in dc_fields(SystemState):
        value = getattr(state, f.name)
        if f.name in _GROUPS:
            for g in dc_fields(value):
                out[f"{f.name}.{g.name}"] = getattr(value, g.name)
        else:
            out[f.name] = value
    return out


def system_state_to_numpy(state: SystemState) -> dict[str, np.ndarray]:
    """Flat numpy dict of every tensor in ``state`` (copied to the host)."""
    return {k: v.detach().cpu().numpy()
            for k, v in state_tensors(state).items()}

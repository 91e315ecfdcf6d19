"""Simulation state: plain dataclasses of tensors with ``.replace()``.

Shapes:
  * sigma, energy, vaz, qplus, qminus: (NR, NAZ) — ring 0 / NR-1 ghost
  * vrad:                              (NR+1, NAZ) — radial faces
  * nbody.*: (N_bodies,) float64; omega_frame, frame_angle: 0-d

``system_state_from_numpy`` / ``system_state_to_numpy`` carry a state
across packages as a flat dict of numpy arrays keyed by dotted names
(``"fields.sigma"``, ``"nbody.x"``, ``"monitor_acc.mass_delta"``, ...),
so a run can start from another implementation's state. The optional
parts are keyed by position: ``"pvte_guess.0"``, ``"pvte_guess.1"``,
``"fld_sor"``, ``"sg_kernel.0"`` .. ``"sg_kernel.3"``; the dust swarm by
field: ``"particles.r"``, ``"particles.alive"``, ...; the monitor grids
that are on and the Roche-lobe tracker's rate under the JAX package's
names (``"monitor_acc.massflow"``, ..., ``"monitor_acc.rof_mdot"``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields, replace

import numpy as np
import torch

from .nbody.system import NBodyState
from .particles.dust import ParticleState


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
# the stages of the eccentricity-change monitor (reference
# write_ecc_peri_changes): sources, artificial viscosity, viscosity,
# transport, damping
N_ECC_STAGES = 5


@dataclass(frozen=True)
class MonitorAccum:
    """Values accumulated over the steps of a monitor interval (reference
    src/quantities.cpp:976-998, src/TransportEuler.cpp:610-616): the mass
    bookkeeping (reference src/types.h:30-60 BoundaryFlow, always), and the
    grids of the ``Write*`` flags that are on, None otherwise: the mass
    through each face (massflow), the advection, viscous and gravitational
    torques times dt (t_adv, t_visc, t_grav), alpha times dt
    (alpha_grav_mean, alpha_reynolds_mean), and the disk's eccentricity and
    pericentre changes per stage (decc, dperi, N_ECC_STAGES each); and,
    with RocheLobeOverflow, the Roche-lobe tracker's exponentially averaged
    rate through the inner face (rof_mdot, 0-d; reference
    src/massflow_tracker.cpp), which the Euler step updates and
    ROFVariableTransfer feeds to the stream."""
    mass_delta: torch.Tensor
    massflow: torch.Tensor | None = None
    t_adv: torch.Tensor | None = None
    t_visc: torch.Tensor | None = None
    t_grav: torch.Tensor | None = None
    alpha_grav_mean: torch.Tensor | None = None
    alpha_reynolds_mean: torch.Tensor | None = None
    decc: torch.Tensor | None = None
    dperi: torch.Tensor | None = None
    rof_mdot: torch.Tensor | None = None

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
    # (gamma_eff, mu) of the newest PVTE refresh, the warm start of the
    # next one (float32 PVTE runs; None otherwise)
    pvte_guess: tuple | None = None
    # [omega, direction, old_iterations] of the FLD SOR auto-omega walk
    # (reference src/fld.cpp:698-700; None unless
    # RadiativeDiffusionAutoOmega)
    fld_sor: torch.Tensor | None = None
    # (k_r_hat, k_t_hat, last_aspect_ratio, since_last) of the adiabatic
    # self-gravity kernel refresh (reference selfgravity.cpp:186-214);
    # since_last is a host int
    sg_kernel: tuple | None = None
    # the dust swarm (IntegrateParticles; None otherwise)
    particles: ParticleState | None = None

    def replace(self, **kw) -> "SystemState":
        return replace(self, **kw)


_GROUPS = {"fields": FieldState, "nbody": NBodyState,
           "monitor_acc": MonitorAccum}
_OPTIONAL = ("pvte_guess", "fld_sor", "sg_kernel", "particles")
# the monitor grids, each None while its flag is off
MONITOR_GRIDS = ("massflow", "t_adv", "t_visc", "t_grav", "alpha_grav_mean",
                 "alpha_reynolds_mean", "decc", "dperi")
# the parts of MonitorAccum that a run may lack
_MONITOR_OPTIONAL = MONITOR_GRIDS + ("rof_mdot",)
_NBODY_KEYS = {"nbody.x", "nbody.y", "nbody.vx", "nbody.vy", "nbody.mass",
               "corot_ref_x", "corot_ref_y"}


def state_keys() -> list[str]:
    """The dotted names of every tensor of a ``SystemState`` without its
    optional parts (nor the monitor grids and the Roche-lobe tracker)."""
    keys = []
    for f in dc_fields(SystemState):
        if f.name in _OPTIONAL:
            continue
        group = _GROUPS.get(f.name)
        if group is None:
            keys.append(f.name)
        else:
            keys.extend(f"{f.name}.{g.name}" for g in dc_fields(group)
                        if g.name not in _MONITOR_OPTIONAL)
    return keys


def system_state_from_numpy(tree: dict[str, np.ndarray],
                            device: torch.device | str,
                            dtype: torch.dtype) -> SystemState:
    """Build a ``SystemState`` on ``device`` from a flat numpy dict. Field
    and scalar entries take ``dtype`` (the self-gravity spectra its complex
    type, the particles' ``alive`` bool); body entries are float64. The
    optional parts are set when the dict holds them."""
    missing = set(state_keys()) - set(tree)
    if missing:
        raise KeyError(f"state dict lacks {sorted(missing)}")
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128

    def t(key, dt=None):
        dt = dt or (torch.float64 if key in _NBODY_KEYS else dtype)
        return torch.tensor(np.asarray(tree[key]), dtype=dt, device=device)

    parts = {}
    for f in dc_fields(SystemState):
        group = _GROUPS.get(f.name)
        if f.name in _OPTIONAL:
            continue
        if group is None:
            parts[f.name] = t(f.name)
        else:
            parts[f.name] = group(**{g.name: t(f"{f.name}.{g.name}")
                                     for g in dc_fields(group)
                                     if f"{f.name}.{g.name}" in tree})
    if "pvte_guess.0" in tree:
        parts["pvte_guess"] = (t("pvte_guess.0"), t("pvte_guess.1"))
    if "fld_sor" in tree:
        parts["fld_sor"] = t("fld_sor")
    if "sg_kernel.0" in tree:
        parts["sg_kernel"] = (t("sg_kernel.0", cdtype),
                              t("sg_kernel.1", cdtype), t("sg_kernel.2"),
                              int(tree["sg_kernel.3"]))
    if "particles.r" in tree:
        parts["particles"] = ParticleState(**{
            f.name: t(f"particles.{f.name}",
                      torch.bool if f.name == "alive" else None)
            for f in dc_fields(ParticleState)})
    return SystemState(**parts)


def _flat(state: SystemState) -> dict:
    out = {}
    for f in dc_fields(SystemState):
        value = getattr(state, f.name)
        if f.name in _GROUPS or isinstance(value, ParticleState):
            for g in dc_fields(value):
                if getattr(value, g.name) is not None:
                    out[f"{f.name}.{g.name}"] = getattr(value, g.name)
        elif isinstance(value, tuple):
            out.update({f"{f.name}.{k}": v for k, v in enumerate(value)})
        elif value is not None:
            out[f.name] = value
    return out


def state_tensors(state: SystemState) -> dict[str, torch.Tensor]:
    """Flat dict of every tensor in ``state`` (no copies)."""
    return {k: v for k, v in _flat(state).items() if torch.is_tensor(v)}


def system_state_to_numpy(state: SystemState) -> dict[str, np.ndarray]:
    """Flat numpy dict of every entry of ``state`` (copied to the host)."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in _flat(state).items()}

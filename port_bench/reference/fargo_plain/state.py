"""Simulation state: plain dataclasses of tensors with ``.replace()``.

Shapes:
  * sigma, energy, vaz, qplus, qminus: (NR, NAZ) — ring 0 / NR-1 ghost
  * vrad:                              (NR+1, NAZ) — radial faces
  * nbody.*: (N_bodies,) float64; omega_frame, frame_angle: 0-d
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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













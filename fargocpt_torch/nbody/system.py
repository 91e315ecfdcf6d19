"""N-body system: configuration, Jacobi initialization, frame centering,
kicks and rotations (reference src/nbody/planetary_system.cpp,
src/nbody/planet.cpp, src/frame_of_reference.cpp).

The body state is always float64, whatever the field dtype; the gas-side
ops cast body values to the field dtype where they meet the grid. Only the
lone-star case integrates (trivially): mutual-gravity integration of more
bodies needs IAS15, which is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import units as u
from ..config import Config
from ..ops.common import accurate_cos


@dataclass(frozen=True)
class NBodyState:
    """Dynamic per-body state (length-N float64 tensors)."""
    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    mass: torch.Tensor

    def replace(self, **kw) -> "NBodyState":
        return replace(self, **kw)

    @property
    def n(self) -> int:
        return self.x.shape[0]


@dataclass(frozen=True)
class BodyConfig:
    """Static per-body configuration (reference
    src/nbody/planetary_system.cpp:161-258 ``init_planet``)."""
    name: str = "body"
    mass: float = 1.0
    semi_major_axis: float = 0.0
    eccentricity: float = 0.0
    argument_of_pericenter: float = 0.0
    true_anomaly: float = 0.0
    radius: float = 0.009304813          # in l0 (solar radius in au)
    temperature: float = 0.0             # code units
    irradiate: bool = False
    irradiation_rampup: float = 0.0
    ramp_up_time: float = 0.0            # in orbital periods
    cubic_smoothing_factor: float = 0.0
    accretion_efficiency: float = 0.0
    accretion_type: str = "none"         # none | kley | sinkhole | viscous


def parse_bodies(cfg: Config, units: u.Units) -> list[BodyConfig]:
    bodies = []
    for i, sub in enumerate(cfg.get_subconfigs("nbody")):
        if not (sub.contains("semi-major axis") and sub.contains("mass")):
            raise ValueError(
                "every nbody entry needs 'semi-major axis' and 'mass'")
        temperature = sub.get("temperature", 0.0, dim=u.DIM_TEMPERATURE,
                              type=float)
        acc_eff = sub.get("accretion efficiency", 0.0, type=float)
        acc_type = sub.get_lowercase("accretion method", "kley")
        if acc_type in ("no", "none") or acc_eff <= 0.0:
            acc_type = "none"
        bodies.append(BodyConfig(
            name=sub.get("name", f"planet{i}", type=str),
            mass=sub.get("mass", 1.0, dim=u.DIM_MASS, type=float),
            semi_major_axis=sub.get("semi-major axis", 0.0,
                                    dim=u.DIM_LENGTH, type=float),
            eccentricity=sub.get("eccentricity", 0.0, type=float),
            argument_of_pericenter=sub.get("argument of pericenter", 0.0,
                                           type=float),
            true_anomaly=sub.get("trueanomaly", 0.0, type=float),
            radius=sub.get("radius", 0.009304813, dim=u.DIM_LENGTH,
                           type=float),
            temperature=temperature,
            irradiate=temperature > 0.0,
            irradiation_rampup=sub.get("irradiation ramp-up time", 0.0,
                                       dim=u.DIM_TIME, type=float),
            ramp_up_time=sub.get("ramp-up time", 0.0, type=float),
            cubic_smoothing_factor=sub.get("cubic smoothing factor", 0.0,
                                           type=float),
            accretion_efficiency=acc_eff,
            accretion_type=acc_type,
        ))
    if not bodies:
        bodies.append(BodyConfig(name="DefaultStar", mass=1.0))
    return bodies


def hydroframe_center_count(cfg: Config, n_bodies: int) -> int:
    """reference src/Interpret.cpp:326-346."""
    mode = cfg.get_lowercase("HydroFrameCenter", "primary")[:1]
    n = {"p": 1, "b": 2, "t": 3, "q": 4, "a": 0}.get(mode)
    if n is None:
        raise ValueError(f"invalid HydroFrameCenter {mode!r}")
    if n == 0 or n > n_bodies:
        n = n_bodies
    return n


def _kepler_cartesian(G, com_mass, mass, a, e, omega, nu):
    """Position/velocity on a Kepler orbit around the running center of
    mass (reference src/nbody/planetary_system.cpp:539-575)."""
    r = a * (1 - e * e) / (1 + e * math.cos(nu))
    x = r * math.cos(omega + nu)
    y = r * math.sin(omega + nu)
    v = math.sqrt(G * (com_mass + mass) / (a * (1 - e * e))) if a > 0 else 0.0
    vx = v * (-math.cos(omega) * math.sin(nu)
              - math.sin(omega) * (e + math.cos(nu)))
    vy = v * (-math.sin(omega) * math.sin(nu)
              + math.cos(omega) * (e + math.cos(nu)))
    return x, y, vx, vy


def initialize_system(bodies: list[BodyConfig], G: float,
                      n_hydroframe: int) -> dict[str, np.ndarray]:
    """Jacobi-coordinate initialization + hydro-frame centering
    (reference src/nbody/planetary_system.cpp:483-575, :750-767).
    Returns float64 numpy arrays {x, y, vx, vy, mass}."""
    n = len(bodies)
    x = np.zeros(n)
    y = np.zeros(n)
    vx = np.zeros(n)
    vy = np.zeros(n)
    m = np.array([b.mass for b in bodies], dtype=np.float64)

    for k, b in enumerate(bodies):
        if k == 0:
            continue  # first body starts at origin
        omega = b.argument_of_pericenter
        if k == 1 and n >= 2 and b.mass > bodies[0].mass:
            omega = omega + math.pi
        com_m = m[:k].sum()
        com_x = (m[:k] * x[:k]).sum() / com_m
        com_y = (m[:k] * y[:k]).sum() / com_m
        px, py, pvx, pvy = _kepler_cartesian(G, com_m, b.mass,
                                             b.semi_major_axis,
                                             b.eccentricity, omega,
                                             b.true_anomaly)
        if k == 1:
            k1 = b.mass / (m[0] + b.mass)
            k2 = m[0] / (m[0] + b.mass)
            x[0], y[0], vx[0], vy[0] = -k1 * px, -k1 * py, -k1 * pvx, -k1 * pvy
            x[1], y[1], vx[1], vy[1] = k2 * px, k2 * py, k2 * pvx, k2 * pvy
        else:
            x[k] = com_x + px
            y[k] = com_y + py
            vx[k] = pvx
            vy[k] = pvy

    mc = m[:n_hydroframe].sum()
    cx = (m[:n_hydroframe] * x[:n_hydroframe]).sum() / mc
    cy = (m[:n_hydroframe] * y[:n_hydroframe]).sum() / mc
    cvx = (m[:n_hydroframe] * vx[:n_hydroframe]).sum() / mc
    cvy = (m[:n_hydroframe] * vy[:n_hydroframe]).sum() / mc
    return {"x": x - cx, "y": y - cy, "vx": vx - cvx, "vy": vy - cvy,
            "mass": m}


def make_state(init: dict[str, np.ndarray],
               device: torch.device | str) -> NBodyState:
    """Float64 body state on ``device``."""
    return NBodyState(**{k: torch.tensor(np.asarray(v, np.float64),
                                         dtype=torch.float64, device=device)
                         for k, v in init.items()})


def integrate(state: NBodyState, G: float, dt,
              method: str = "ias15") -> NBodyState:
    """Advance the bodies under mutual gravity by dt. A lone star does not
    move (reference early return, fargocpt_tpu nbody/system.py:223)."""
    if method not in ("ias15", "rk4", "rk5"):
        raise ValueError(f"unknown NbodyIntegrator '{method}' "
                         "(expected ias15, rk4 or rk5)")
    if state.n == 1:
        return state
    raise NotImplementedError(
        "N-body integration of more than one body is not ported yet")


def move_to_hydro_frame_center(state: NBodyState,
                               n_center: int) -> NBodyState:
    """Subtract the COM (position & velocity) of the first n_center bodies
    (reference src/nbody/planetary_system.cpp:750-767)."""
    m = state.mass[:n_center]
    mc = torch.sum(m)
    cx = torch.sum(m * state.x[:n_center]) / mc
    cy = torch.sum(m * state.y[:n_center]) / mc
    cvx = torch.sum(m * state.vx[:n_center]) / mc
    cvy = torch.sum(m * state.vy[:n_center]) / mc
    return state.replace(x=state.x - cx, y=state.y - cy,
                         vx=state.vx - cvx, vy=state.vy - cvy)


def rotate(state: NBodyState, angle: torch.Tensor) -> NBodyState:
    """Rotate all bodies by -angle (reference
    src/nbody/planetary_system.cpp:412-437)."""
    angle = angle.to(state.x.dtype)
    c = accurate_cos(angle)
    s = torch.sin(angle)
    return state.replace(
        x=state.x * c + state.y * s, y=-state.x * s + state.y * c,
        vx=state.vx * c + state.vy * s, vy=-state.vx * s + state.vy * c)


def kick(state: NBodyState, ax, ay, dt) -> NBodyState:
    """Velocity kick (reference src/nbody/planetary_system.cpp:730-744)."""
    dt = dt.to(state.vx.dtype)
    return state.replace(vx=state.vx + dt * ax.to(state.vx.dtype),
                         vy=state.vy + dt * ay.to(state.vy.dtype))


def orbital_elements(x, y, vx, vy, m_central, m_body, G):
    """Keplerian elements from state vectors
    (reference src/nbody/planet.cpp:488-570). numpy, host-side."""
    m = m_central + m_body
    h = x * vy - y * vx
    d = np.sqrt(x * x + y * y)
    if d == 0.0 or h == 0.0:
        return dict(a=0.0, e=0.0, period=0.0, mean_anomaly=0.0,
                    true_anomaly=0.0, eccentric_anomaly=0.0,
                    pericenter_angle=0.0)
    Ax = x * vy * vy - y * vx * vy - G * m * x / d
    Ay = y * vx * vx - x * vx * vy - G * m * y / d
    e = math.sqrt(Ax * Ax + Ay * Ay) / (G * m)
    a = h * h / (G * m) / (1.0 - e * e)
    if e >= 1.0 or a <= 0.0:
        return dict(a=0.0, e=0.0, period=0.0, mean_anomaly=0.0,
                    true_anomaly=0.0, eccentric_anomaly=0.0,
                    pericenter_angle=0.0)
    period = 2.0 * math.pi * math.sqrt(a ** 3 / (G * m))
    if e != 0.0:
        E = math.acos(np.clip((1.0 - d / a) / e, -1.0, 1.0))
    else:
        E = 0.0
    if (x * y * (vy * vy - vx * vx) + vx * vy * (x * x - y * y)) < 0:
        E = -E
    M = E - e * math.sin(E)
    if e != 0.0:
        V = math.acos(np.clip((a * (1.0 - e * e) / d - 1.0) / e, -1.0, 1.0))
    else:
        V = 0.0
    if x * vx + y * vy < 0:
        V = -V
    peri = math.atan2(Ay, Ax) if e != 0.0 else 0.0
    return dict(a=float(a), e=float(e), period=float(period),
                mean_anomaly=float(M), true_anomaly=float(V),
                eccentric_anomaly=float(E), pericenter_angle=float(peri))

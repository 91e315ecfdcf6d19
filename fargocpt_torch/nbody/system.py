"""N-body system: configuration, Jacobi initialization, frame centering,
kicks and rotations (reference src/nbody/planetary_system.cpp,
src/nbody/planet.cpp, src/frame_of_reference.cpp).

The body state is always float64, whatever the field dtype; the gas-side
ops cast body values to the field dtype where they meet the grid. More
than one body integrates under mutual gravity with IAS15 (``ias15.py``;
on the GPU its CUDA kernel, ``ops/kernels.ias15``), or with the
fixed-substep RK4 / Cash-Karp RK5 of ``NbodyIntegrator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import telemetry, units as u
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


def mutual_accelerations(x, y, mass, G):
    """Pairwise gravitational accelerations, O(N^2), N tiny."""
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    d2 = dx * dx + dy * dy
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    inv_d3 = torch.where(d2 > 0.0, (d2 + eye) ** -1.5, torch.zeros_like(d2))
    ax = G * torch.sum(mass[None, :] * dx * inv_d3, dim=1)
    ay = G * torch.sum(mass[None, :] * dy * inv_d3, dim=1)
    return ax, ay


# Cash-Karp stage coefficients (reference src/RungeKutta.cpp:73-86) and
# 5th-order weights (:88-91, corrected to y0 + h sum(b_i k_i))
_RK5_A = (
    (0.2,),
    (0.075, 0.225),
    (0.3, -0.9, 1.2),
    (-11.0 / 54.0, 2.5, -70.0 / 27.0, 35.0 / 27.0),
    (1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0,
     44275.0 / 110592.0, 253.0 / 4096.0),
)
_RK5_B = (37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0,
          512.0 / 1771.0)


def integrate(state: NBodyState, G: float, dt, n_substeps: int = 16,
              method: str = "ias15") -> NBodyState:
    """Advance the bodies under mutual gravity by exactly dt (a float or a
    0-d tensor). ``ias15`` (the default): the adaptive Gauss-Radau
    integrator in float64, the ``ias15`` CUDA kernel for tensors on the
    GPU; ``rk4``: fixed-substep RK4; ``rk5``: the corrected Cash-Karp
    tableau of the reference's dead src/RungeKutta.cpp:12-92
    (fargocpt_tpu/nbody/system.py:208-285). A lone star does not move."""
    if method not in ("ias15", "rk4", "rk5"):
        raise ValueError(f"unknown NbodyIntegrator '{method}' "
                         "(expected ias15, rk4 or rk5)")
    if state.n == 1:
        return state
    if method == "ias15":
        from ..ops import kernels
        with telemetry.span("nbody.ias15"):
            x, y, vx, vy = kernels.ias15(state.x, state.y, state.vx,
                                         state.vy, state.mass, G, dt)
        return state.replace(x=x, y=y, vx=vx, vy=vy)
    dt = torch.as_tensor(dt, dtype=state.x.dtype, device=state.x.device)
    h = dt / n_substeps
    m = state.mass

    def deriv(q):
        ax, ay = mutual_accelerations(q[0], q[1], m, G)
        return (q[2], q[3], ax, ay)

    def rk4(q):
        k1 = deriv(q)
        k2 = deriv(tuple(a + 0.5 * h * b for a, b in zip(q, k1)))
        k3 = deriv(tuple(a + 0.5 * h * b for a, b in zip(q, k2)))
        k4 = deriv(tuple(a + h * b for a, b in zip(q, k3)))
        return tuple(a + h / 6.0 * (b1 + 2 * b2 + 2 * b3 + b4)
                     for a, b1, b2, b3, b4 in zip(q, k1, k2, k3, k4))

    def rk5(q):
        ks = [deriv(q)]
        for row in _RK5_A:
            ks.append(deriv(tuple(
                a + h * sum(c * k[i] for c, k in zip(row, ks))
                for i, a in enumerate(q))))
        return tuple(a + h * sum(b * k[i] for b, k in zip(_RK5_B, ks))
                     for i, a in enumerate(q))

    body = rk4 if method == "rk4" else rk5
    q = (state.x, state.y, state.vx, state.vy)
    for _ in range(n_substeps):
        q = body(q)
    return state.replace(x=q[0], y=q[1], vx=q[2], vy=q[3])


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


def rampup_masses(state: NBodyState, ramp_time: torch.Tensor, time):
    """The masses the gas feels, ramped over ``ramp_time`` (the ramp-up
    periods times each body's orbital period; 0 = no ramp) at ``time``, a
    float or a 0-d tensor (reference src/nbody/planet.cpp:166-179)."""
    t = torch.as_tensor(time, dtype=state.mass.dtype,
                        device=state.mass.device)
    active = ramp_time > 0.0
    safe = torch.where(active, ramp_time, torch.ones_like(ramp_time))
    frac = torch.where(active & (t < ramp_time),
                       1.0 - torch.cos(t * (math.pi / 2.0) / safe) ** 2,
                       torch.ones_like(ramp_time))
    return state.mass * frac


def dist_to_primary(state: NBodyState):
    dx = state.x - state.x[0]
    dy = state.y - state.y[0]
    return torch.sqrt(dx * dx + dy * dy)


def dimensionless_roche_radius(state: NBodyState):
    """L1 distance fraction x for each body orbiting the primary; 0 for
    the primary. On a CUDA state it is the Roche output of the
    ``bodies_on_grid`` kernel, elsewhere ``roche_radius_plain``."""
    if state.mass.device.type == "cuda":
        from ..ops import kernels
        return kernels.bodies_on_grid(state)[1]
    return roche_radius_plain(state)


@telemetry.spanned("nbody.roche_radius")
def roche_radius_plain(state: NBodyState, n_iter: int = 12):
    """``dimensionless_roche_radius`` as PyTorch ops (reference
    src/Theo.cpp:251-277 init_l1, Newton iteration): the CPU path and the
    kernel's oracle."""
    mc = state.mass[0]
    mo = state.mass
    q = mc / (mc + mo)
    ratio = mo / torch.clamp(3.0 * mc, min=1e-300)
    x = torch.clamp(torch.sign(ratio) * torch.abs(ratio) ** (1.0 / 3.0),
                    1e-8, 0.9)
    for _ in range(n_iter):
        f = q / (1.0 - x) ** 2 - (1.0 - q) / x ** 2 - q + x
        df = 2.0 * q / (1.0 - x) ** 3 + 2.0 * (1.0 - q) / x ** 3 + 1.0
        x = x - f / df
    return torch.cat([torch.zeros_like(x[:1]), x[1:]])


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

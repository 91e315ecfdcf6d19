"""Adaptive 15th-order Gauss-Radau N-body integrator (IAS15; Rein &
Spiegel 2015, MNRAS 446, 1424), the integrator the reference takes from
REBOUND (src/nbody/planetary_system.cpp:35-64, :878) and the JAX package
writes as one ``lax.while_loop`` (``fargocpt_tpu/nbody/ias15.py:89-272``).

This module is the plain PyTorch version: functions on (N,) float64
tensors, a Python loop over the substeps with one host read per test. It
keeps the JAX package's design: every call starts from fresh b/e seeds and
a trial step of the whole interval, finishes exactly at ``dt``, keeps
Kahan-compensated position and velocity sums, and stops at
``MAX_SUBSTEPS``. On the GPU the step calls the ``ias15`` CUDA kernel
(``csrc/ias15.cu``, ``ops/kernels.ias15``), which runs a whole call on the
device in this order of arithmetic; the two are held to each other there.

The Gauss-Radau node constants (h, rr, c, d) are the published values of
Everhart (1985) / Rein & Spiegel (2015).
"""

from __future__ import annotations

import numpy as np
import torch

# Gauss-Radau spacings (nodes of the 8-point Radau IIA quadrature on [0,1])
H_NODES = np.array([
    0.0,
    0.0562625605369221464656521910318,
    0.180240691736892364987579942780,
    0.352624717113169637373907769648,
    0.547153626330555383001448554766,
    0.734210177215410531523210605558,
    0.885320946839095768090359771030,
    0.977520613561287501891174488626,
])

# rr[j] = h[n] - h[m], the pair differences in divided-difference order
RR = np.zeros(28)
_k = 0
for _n in range(1, 8):
    for _m in range(_n):
        RR[_k] = H_NODES[_n] - H_NODES[_m]
        _k += 1

# c: divided differences g -> polynomial coefficients b; d its inverse
# (Everhart's recurrence)
C = np.zeros((8, 8))
D = np.zeros((8, 8))
for _i in range(8):
    C[_i, _i] = 1.0
    D[_i, _i] = 1.0
for _i in range(1, 8):
    C[_i, 0] = -H_NODES[_i] * C[_i - 1, 0]
    D[_i, 0] = H_NODES[1] * D[_i - 1, 0]
    for _j in range(1, _i):
        C[_i, _j] = C[_i - 1, _j - 1] - H_NODES[_i] * C[_i - 1, _j]
        D[_i, _j] = D[_i - 1, _j - 1] + H_NODES[_j + 1] * D[_i - 1, _j]

SAFETY = 0.25         # max shrink per rejection / max growth 1 / SAFETY
EPS_DEFAULT = 1e-9    # REBOUND's ri_ias15.epsilon default
MAX_PC_ITER = 12      # predictor-corrector iteration cap
MAX_SUBSTEPS = 4096   # backstop against pathological shrink loops

# position-series weights: x gets dt^2 b_j / XW[j]; velocity: dt b_j / VW[j]
XW = np.array([6.0, 12.0, 20.0, 30.0, 42.0, 56.0, 72.0])
VW = np.array([2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])

PASCAL = np.array([
    [1., 2., 3., 4., 5., 6., 7.],
    [0., 1., 3., 6., 10., 15., 21.],
    [0., 0., 1., 4., 10., 20., 35.],
    [0., 0., 0., 1., 5., 15., 35.],
    [0., 0., 0., 0., 1., 6., 21.],
    [0., 0., 0., 0., 0., 1., 7.],
    [0., 0., 0., 0., 0., 0., 1.],
])

PC_TOL = 0.45 * float(np.finfo(np.float64).eps)


class _Divisors:
    """The constant divisors of the scheme as float64 tensors on the
    bodies' device. A division by a tensor is correctly rounded on either
    device, as the kernel's is; a division by a Python number, PyTorch's
    CUDA backend turns into a product with its reciprocal."""

    def __init__(self, device, epsilon):
        t = lambda v: torch.tensor(v, dtype=torch.float64,  # noqa: E731
                                   device=device)
        self.rr, self.xw, self.vw = t(RR), t(XW), t(VW)
        self.n3, self.n5, self.n7, self.n9 = t(3.0), t(5.0), t(7.0), t(9.0)
        self.epsilon = t(epsilon)


def mutual_accel(x, y, m, G):
    """Pairwise planar gravitational accelerations, (N,) each. d^-3 is
    1 / (d^2 sqrt(d^2)) and the sum over the bodies runs in index order:
    two correctly rounded operations and one order, which the kernel
    repeats exactly (the JAX package takes pow(d^2, -1.5) and XLA's
    sum)."""
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    d2 = dx * dx + dy * dy
    inv_d3 = torch.where(d2 > 0.0, 1.0 / (d2 * torch.sqrt(d2)),
                         torch.zeros_like(d2))
    tx = m[None, :] * dx * inv_d3
    ty = m[None, :] * dy * inv_d3
    sx, sy = tx[:, 0], ty[:, 0]
    for j in range(1, m.shape[0]):
        sx = sx + tx[:, j]
        sy = sy + ty[:, j]
    return G * sx, G * sy


def _accel(q, m, G):
    n = m.shape[0]
    ax, ay = mutual_accel(q[:n], q[n:], m, G)
    return torch.cat([ax, ay])


def _predict_pos(x0, v0, a0, b, hn, dt, k: _Divisors):
    """Position at Radau node hn from the b series (the nested Horner form
    of the twice-integrated acceleration polynomial)."""
    s = b[6] * 7.0 * hn / k.n9 + b[5]
    s = s * 3.0 * hn / 4.0 + b[4]
    s = s * 5.0 * hn / k.n7 + b[3]
    s = s * 2.0 * hn / k.n3 + b[2]
    s = s * 3.0 * hn / k.n5 + b[1]
    s = s * hn / 2.0 + b[0]
    s = s * hn / k.n3 + a0
    return (s * dt * hn / 2.0 + v0) * dt * hn + x0


def _g_from_accel(n, at, a0, g, k: _Divisors):
    """Divided difference g_{n-1} from the acceleration at node n."""
    base = (n - 1) * n // 2    # start of row n-1 in the rr triangle
    val = (at - a0) / k.rr[base]
    for j in range(1, n):
        val = (val - g[j - 1]) / k.rr[base + j]
    return val


def _pc_sweep(x0, v0, a0, b, g, dt, m, G, k: _Divisors):
    """One corrector sweep over the 7 nodes (b and g updated in place);
    returns the relative size of the last b6 change."""
    for n in range(1, 8):
        hn = H_NODES[n]
        at = _accel(_predict_pos(x0, v0, a0, b, hn, dt, k), m, G)
        g_new = _g_from_accel(n, at, a0, g, k)
        delta = g_new - g[n - 1]
        g[n - 1] = g_new
        for j in range(n - 1):
            b[j] = b[j] + delta * C[n - 1, j]
        b[n - 1] = b[n - 1] + delta
    db6 = torch.max(torch.abs(delta))
    atm = torch.max(torch.abs(at))
    return torch.where(atm > 0.0, db6 / atm, torch.zeros_like(db6))


def _add_cs(val, cs, inc):
    """Kahan-compensated val + inc."""
    y = inc - cs
    t = val + y
    return t, (t - val) - y


def _step_trial(x0, v0, csx, csv, a0, b, e, dt, m, G, k: _Divisors):
    """One trial step of size ``dt``. Returns (x1, v1, csx1, csv1, b_next,
    e_next, dt_next, accept)."""
    # seed g from b through D, so a predicted b starts the corrector warm
    g = torch.stack([sum(b[j] * D[j, i] for j in range(i, 7))
                     for i in range(7)])
    b = b.clone()
    err = err_last = float(np.finfo(np.float64).max)
    it = 0
    while err >= PC_TOL and it < MAX_PC_ITER and (it <= 2 or err_last > err):
        err_last, err = err, float(_pc_sweep(x0, v0, a0, b, g, dt, m, G,
                                             k))
        it += 1

    x1, csx1, v1, csv1 = x0, csx, v0, csv
    dt2 = dt * dt
    for j in range(6, -1, -1):
        x1, csx1 = _add_cs(x1, csx1, b[j] / k.xw[j] * dt2)
    x1, csx1 = _add_cs(x1, csx1, a0 / 2.0 * dt2)
    x1, csx1 = _add_cs(x1, csx1, v0 * dt)
    for j in range(6, -1, -1):
        v1, csv1 = _add_cs(v1, csv1, b[j] / k.vw[j] * dt)
    v1, csv1 = _add_cs(v1, csv1, a0 * dt)

    # error from the highest-order term, over the bodies that move
    # (REBOUND's epsilon_global = 1 with its slowly-varying filter)
    n = m.shape[0]
    at = _accel(x1, m, G)
    v2 = v1[:n] ** 2 + v1[n:] ** 2
    x2 = x1[:n] ** 2 + x1[n:] ** 2
    active = torch.abs(v2 * dt2 / torch.where(x2 > 0, x2,
                                              torch.ones_like(x2))) >= 1e-16
    act2 = torch.cat([active, active])
    zero = torch.zeros_like(at)
    maxak = torch.max(torch.where(act2, torch.abs(at), zero))
    maxb6 = torch.max(torch.where(act2, torch.abs(b[6]), zero))
    err = torch.where(maxak > 0.0, maxb6 / maxak, torch.zeros_like(maxak))

    dt_new = torch.where((err > 0.0) & torch.isfinite(err),
                         (k.epsilon / err) ** (1.0 / 7.0) * dt,
                         dt / SAFETY)
    accept = torch.abs(dt_new / dt) >= SAFETY
    dt_next = torch.where(accept, torch.minimum(dt_new, dt / SAFETY), dt_new)

    # predict b and e forward to the next trial size; ratio^(j+1) by
    # successive products
    ratio = dt_next / dt
    be = b - e
    powers = [ratio]
    for _ in range(6):
        powers.append(powers[-1] * ratio)
    e_next = torch.stack([
        powers[j] * sum(float(PASCAL[j, k]) * b[k] for k in range(7))
        for j in range(7)])
    b_next = e_next + be
    # a very large growth invalidates the polynomial extrapolation
    if bool(ratio > 20.0):
        e_next = torch.zeros_like(e_next)
        b_next = torch.zeros_like(b_next)
    return x1, v1, csx1, csv1, b_next, e_next, dt_next, bool(accept)


def integrate_ias15(x, y, vx, vy, m, G, dt, epsilon=EPS_DEFAULT,
                    counts: list | None = None):
    """Advance the planar N-body system by exactly ``dt`` (a float or a
    0-d tensor; exact finish time, as the reference's reb_integrate) with
    adaptive IAS15 substeps, in float64. Returns (x, y, vx, vy); with
    ``counts`` (a list) appends (accepted substeps, trial steps)."""
    f64 = torch.float64
    x, y, vx, vy, m = (t.to(f64) for t in (x, y, vx, vy, m))
    n = x.shape[0]
    q = torch.cat([x, y])
    p = torch.cat([vx, vy])
    csq, csp = torch.zeros_like(q), torch.zeros_like(p)
    k = _Divisors(q.device, epsilon)
    b = torch.zeros((7, 2 * n), dtype=f64, device=q.device)
    e = torch.zeros_like(b)
    dt = torch.as_tensor(dt, dtype=f64, device=q.device)
    eps_t = 1e-14 * torch.abs(dt)
    t = torch.zeros((), dtype=f64, device=q.device)
    dt_int = dt
    trials = accepted = 0
    while bool(t < dt - eps_t) and trials < MAX_SUBSTEPS:
        step_dt = torch.minimum(dt_int, dt - t)
        a0 = _accel(q, m, G)
        q1, p1, csq1, csp1, b, e, dt_next, accept = _step_trial(
            q, p, csq, csp, a0, b, e, step_dt, m, G, k)
        if accept:
            q, p, csq, csp = q1, p1, csq1, csp1
            t = t + step_dt
            accepted += 1
        dt_int = torch.maximum(dt_next, 1e-12 * torch.abs(dt))
        trials += 1
    if counts is not None:
        counts.append((accepted, trials))
    return q[:n], q[n:], p[:n], p[n:]

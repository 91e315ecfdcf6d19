"""PVTE equation of state: the variable effective adiabatic index of
hydrogen ionisation and dissociation (Vaidya et al. 2015; D'Angelo et al.
2013; reference src/pvte_law.cpp).

The temperature is solved per cell from the specific energy and the
midplane density; every ingredient (the Saha fractions, the H2 internal
energy ``funcdum``) is closed-form elementwise math. Two solvers, as in
``fargocpt_tpu.ops.pvte``:

* float64: 48 bisection halvings of log10 T on [1, 1e7] K with the
  piecewise-Chebyshev ``funcdum`` (32 segments, degree 10) and gamma1 by
  finite differences (``temperature_from_energy``, ``gamma1_at``);
* float32: the unrolled 13 bisection + 4 Illinois solve in t = ln T
  (``_temperature_fast``), or, warm-started from a previous refresh's
  (gamma_eff, mu), ``n_newton`` bracket-safeguarded Newton steps
  (``_temperature_warm``); ``funcdum`` by static Chebyshev segments
  evaluated with Clenshaw, and gamma1 from analytic derivatives
  (``gamma_mu_fast``).

The table builders are numpy and run once on the host. With
``PVTELookupTable`` both dtypes take the reference's bilinear lookup in
its 1000 x 1000 (rho, e) tables instead (``lookup_tables``,
``lookup_gamma_mu``), built once per process in float64 on the run's
device by a replica of the reference's Brent solver.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# cgs constants (reference src/constants.cpp:39-45)
CGS_M_E = 9.1093826e-28
CGS_EV = 1.602176463158e-12
CGS_M_H = 1.6733e-24
CGS_KB = 1.380649e-16
CGS_H = 6.62607015e-27
CGS_HBAR = CGS_H / (2.0 * math.pi)
CGS_MP = 1.67262192369e-24

# zeta-table parameters (reference src/pvte_law.cpp:44-52)
THETA_V = 6140.0
THETA_R = 85.5
N_ZETA = 5000
T0_ZETA = 1.0
TMAX_ZETA = 1.0e12


def _funcdum_exact_np(T: np.ndarray) -> np.ndarray:
    """Exact funcdum(T) of the H2 internal energy (reference :305-369),
    ortho/para mode 1; numpy, chunked over T."""
    alpha, beta, gamma = 1.0, 0.0, 1.0
    T = np.asarray(T, np.float64)
    b1 = 2.0 * THETA_R
    i = np.arange(0, 10001)
    a = 2 * i + 1.0
    b = i * (i + 1.0) * THETA_R
    even = (i % 2) == 0
    zetaP = np.zeros_like(T)
    dzetaP = np.zeros_like(T)
    sum1 = np.zeros_like(T)
    sum2 = np.zeros_like(T)
    chunk = 512
    for lo in range(0, T.size, chunk):
        Ts = T[lo:lo + chunk, None]
        with np.errstate(over="ignore", under="ignore"):
            scrh_e = np.where(even, a * np.exp(-b / Ts), 0.0)
            db = b - b1
            scrh_o = np.where(~even, a * np.exp(-db / Ts), 0.0)
        zetaP[lo:lo + chunk] = scrh_e.sum(1)
        dzetaP[lo:lo + chunk] = (scrh_e * b).sum(1)
        sum1[lo:lo + chunk] = scrh_o.sum(1)
        sum2[lo:lo + chunk] = (scrh_o * db).sum(1)
    inv_T2 = 1.0 / T ** 2
    dzetaP *= inv_T2
    zetaO = np.exp(-b1 / T) * sum1
    dzetaO = np.exp(-b1 / T) * (b1 * sum1 + sum2) * inv_T2
    dzO_zO_m = sum2 / sum1 * inv_T2
    scrh = zetaO * np.exp(2.0 * THETA_R / T)
    zetaR = zetaP ** alpha * scrh ** beta + 3.0 * gamma * zetaO
    dzetaR = (zetaR - 3.0 * gamma * zetaO) * (alpha * dzetaP / zetaP
                                              + beta * dzO_zO_m) \
        + 3.0 * gamma * dzetaO
    dum1 = THETA_V / T
    dum2 = dum1 * np.exp(-dum1) / (1.0 - np.exp(-dum1))
    dum3 = (T / zetaR) * dzetaR
    return 1.5 + dum2 + dum3


# --------------------------------------------------------------------------
# float64 pipeline
# --------------------------------------------------------------------------

FUNCDUM_SEGMENTS = 32
FUNCDUM_DEGREE = 10


@functools.lru_cache(maxsize=1)
def funcdum_poly() -> tuple[float, float, np.ndarray]:
    """(lnT_lo, seg_width, coeffs (K, deg+1) monomial in x) with
    x = 2 (lnT - lo - s w)/w - 1 in segment s, fitted at Chebyshev nodes of
    the exact funcdum over the zeta table's ln T range."""
    K, deg = FUNCDUM_SEGMENTS, FUNCDUM_DEGREE
    dy = math.log(TMAX_ZETA / T0_ZETA) / N_ZETA
    lo = math.log(T0_ZETA)
    hi = lo + (N_ZETA - 2) * dy       # func_dum clips at index N_ZETA-2
    w = (hi - lo) / K
    nodes = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
    coeffs = np.zeros((K, deg + 1))
    for s in range(K):
        a = lo + s * w
        y = 0.5 * (nodes + 1.0) * w + a
        f = _funcdum_exact_np(np.exp(y))
        c_cheb = np.polynomial.chebyshev.chebfit(nodes, f, deg)
        coeffs[s] = np.polynomial.chebyshev.cheb2poly(c_cheb)
    return lo, w, coeffs


def func_dum(tabs, T):
    """funcdum(T) from the segment fit. ``tabs`` is (lo, w, coeffs tensor
    (K, D))."""
    return func_dum_ln(tabs, torch.log(T))


def func_dum_ln(tabs, lnT):
    """func_dum with ln T in hand: the segment's coefficients, then
    Horner."""
    lo, w, coeffs = tabs
    K, D = coeffs.shape
    y = torch.clamp(lnT, lo, lo + K * w)
    s = torch.clamp(((y - lo) / w).to(torch.int32), 0, K - 1)
    x = 2.0 * (y - lo - s.to(y.dtype) * w) / w - 1.0
    c = coeffs[s.long()]                                  # (..., D)
    out = c[..., D - 1]
    for d in range(D - 2, -1, -1):
        out = out * x + c[..., d]
    return out


def ionization_fraction(rho, T, x_mf):
    """Saha H ionisation fraction (reference :443-468) in the conjugate
    root form 2 / (1 + sqrt(1 + 4/A)), stable for every A."""
    rhs_const = CGS_M_H / x_mf * (CGS_M_E * CGS_KB
                                  / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
    ax = rhs_const * T ** 1.5 * torch.exp(-13.60 * CGS_EV / (CGS_KB * T)) \
        / rho
    x = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / ax))
    return torch.where(ax < 1e8, x, 1.0)


def dissociation_fraction(rho, T, x_mf):
    """H2 dissociation fraction (reference :470-495), conjugate form."""
    rhs_const = CGS_M_H / (2.0 * x_mf) \
        * (CGS_M_H * CGS_KB / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5
    ay = rhs_const * T ** 1.5 * torch.exp(-4.48 * CGS_EV / (CGS_KB * T)) \
        / rho
    y = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / ay))
    return torch.where(ay < 1e8, y, 1.0)


def mean_molecular_weight(x, y, x_mf):
    """reference :65-74."""
    return 4.0 / (2.0 * x_mf * (1.0 + y + 2.0 * y * x) + 1.0 - x_mf)


def gas_energy_eps(x, y, T, x_mf, tabs):
    """Dimensionless internal-energy contributions (reference :103-131)."""
    eps_hi = 1.5 * x_mf * (1.0 + x) * y
    eps_he = 0.375 * (1.0 - x_mf)
    eps_hh = 4.48 * CGS_EV * x_mf * y / (2.0 * CGS_KB * T)
    eps_hii = 13.60 * CGS_EV * x_mf * x * y / (CGS_KB * T)
    eps_h2 = 0.5 * x_mf * (1.0 - y) * func_dum(tabs, T)
    return eps_h2 + eps_hii + eps_hh + eps_he + eps_hi


def _gamma_mu_at(rho, T, x_mf, tabs):
    x = ionization_fraction(rho, T, x_mf)
    y = dissociation_fraction(rho, T, x_mf)
    mu = mean_molecular_weight(x, y, x_mf)
    eps = gas_energy_eps(x, y, T, x_mf, tabs)
    gamma_eff = 1.0 + 1.0 / (mu * eps)
    return x, y, mu, eps, gamma_eff


def _eps_lean(rho, t, x_mf, tabs):
    """eps(rho, T) with t = ln T carried by the solver."""
    T = torch.exp(t)
    T32 = T * torch.sqrt(T)
    cx = CGS_M_H / x_mf * (CGS_M_E * CGS_KB
                           / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
    cy = CGS_M_H / (2.0 * x_mf) * (CGS_M_H * CGS_KB
                                   / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5
    ax = cx * T32 * torch.exp(-13.60 * CGS_EV / (CGS_KB * T)) / rho
    ay = cy * T32 * torch.exp(-4.48 * CGS_EV / (CGS_KB * T)) / rho
    x = torch.where(ax < 1e8, 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / ax)), 1.0)
    y = torch.where(ay < 1e8, 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / ay)), 1.0)
    eps_hi = 1.5 * x_mf * (1.0 + x) * y
    eps_he = 0.375 * (1.0 - x_mf)
    eps_hh = 4.48 * CGS_EV * x_mf * y / (2.0 * CGS_KB * T)
    eps_hii = 13.60 * CGS_EV * x_mf * x * y / (CGS_KB * T)
    eps_h2 = 0.5 * x_mf * (1.0 - y) * func_dum_ln(tabs, t)
    return T, eps_h2 + eps_hii + eps_hh + eps_he + eps_hi


def _secant(lo, glo, hi, ghi):
    """Regula-falsi point; the midpoint where g(lo) == g(hi)."""
    d = ghi - glo
    nz = d != 0.0
    return torch.where(nz, (lo * ghi - hi * glo) / torch.where(nz, d, 1.0),
                       0.5 * (lo + hi))


def _temperature_hybrid(e_specific_cgs, rho_cgs, x_mf, tabs,
                        n_bisect: int, n_illinois: int):
    """Bracketing solve of e = R T eps(T, rho) in t = ln T on [1, 1e7] K:
    ``n_bisect`` sign-only halvings, then ``n_illinois`` Illinois steps on
    g(t) = t + ln eps - ln(e/R). Returns T."""
    lo = torch.zeros_like(rho_cgs)
    hi = torch.full_like(rho_cgs, 7.0 * math.log(10.0))
    e_over_R = torch.clamp(e_specific_cgs * (CGS_MP / CGS_KB),
                           min=torch.finfo(e_specific_cgs.dtype).tiny)
    ln_target = torch.log(e_over_R)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        T, eps = _eps_lean(rho_cgs, mid, x_mf, tabs)
        take_low = T * eps > e_over_R
        lo, hi = torch.where(take_low, lo, mid), torch.where(take_low, mid, hi)

    def g(t):
        _, eps = _eps_lean(rho_cgs, t, x_mf, tabs)
        return t + torch.log(eps) - ln_target

    glo, ghi = g(lo), g(hi)
    for _ in range(n_illinois):
        w = hi - lo
        s = torch.clamp(_secant(lo, glo, hi, ghi), lo + 1e-4 * w,
                        hi - 1e-4 * w)
        gs = g(s)
        low = gs < 0.0
        lo, glo, hi, ghi = (torch.where(low, s, lo),
                            torch.where(low, gs, 0.5 * glo),
                            torch.where(low, hi, s),
                            torch.where(low, 0.5 * ghi, gs))
    s = torch.clamp(_secant(lo, glo, hi, ghi), lo, hi)
    return torch.exp(s)


def temperature_from_energy(e_specific_cgs, rho_cgs, x_mf, tabs,
                            n_iter: int | None = None):
    """Invert e(T, rho) = e_specific on [1, 1e7] K: float32 takes the
    13 + 4 bisection/Illinois hybrid, float64 (or an explicit ``n_iter``)
    the bisection of log10 T, 48 halvings by default."""
    if n_iter is None:
        if e_specific_cgs.dtype == torch.float32:
            return _temperature_hybrid(e_specific_cgs, rho_cgs, x_mf, tabs,
                                       n_bisect=13, n_illinois=4)
        n_iter = 48
    R = CGS_KB / CGS_MP

    def resid(T):
        _x, _y, mu, _eps, gam = _gamma_mu_at(rho_cgs, T, x_mf, tabs)
        return mu * e_specific_cgs * (gam - 1.0) / R - T

    lo = torch.zeros_like(rho_cgs)
    hi = torch.full_like(rho_cgs, 7.0)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        take_low = resid(10.0 ** mid) < 0.0
        lo, hi = torch.where(take_low, lo, mid), torch.where(take_low, mid, hi)
    return 10.0 ** (0.5 * (lo + hi))


def gamma1_at(rho, T, x_mf, tabs):
    """First adiabatic index by finite differences (reference :151-213)."""
    epsn = 1e-4
    TL, TR = T * (1 - epsn), T * (1 + epsn)
    dT = TL - TR
    _, _, muL, eL_eps, _ = _gamma_mu_at(rho, TL, x_mf, tabs)
    _, _, muR, eR_eps, _ = _gamma_mu_at(rho, TR, x_mf, tabs)
    _, _, muc, eps, gamma_eff = _gamma_mu_at(rho, T, x_mf, tabs)
    cv = (eL_eps * TL - eR_eps * TR) / dT
    p = (gamma_eff - 1.0) * eps * T
    chiT = 1.0 - T / muc * (muL - muR) / dT
    rhoL, rhoR = rho * (1 - epsn), rho * (1 + epsn)
    dRho = rhoL - rhoR
    _, _, muL2, _, _ = _gamma_mu_at(rhoL, T, x_mf, tabs)
    _, _, muR2, _, _ = _gamma_mu_at(rhoR, T, x_mf, tabs)
    chiRho = 1.0 - rho / muc * (muL2 - muR2) / dRho
    return p * chiT ** 2 / (cv * T) + chiRho


# the lookup tables' grid (reference src/pvte_law.cpp:25-41)
N_RHO = 1000
N_E = 1000
RHO_MIN = 1.0e-23
RHO_MAX = 1.0
E_MIN = 1.0e8
E_MAX = 1.0e15
DLOG_RHO = math.log10(RHO_MAX / RHO_MIN) / N_RHO
DLOG_E = math.log10(E_MAX / E_MIN) / N_E


def _ref_brent_temperature(e_cgs, rho_cgs, x_mf, tabs, delta=1.0e-3):
    """The reference's Brent solve of T(e, rho) on [1, 1e7] K for the
    table build (src/pvte_law.cpp:243-301), elementwise with its quirks,
    which the tables inherit: the loop ends on |b - a| <= ``delta`` in
    absolute Kelvin, ``fc`` is set from ``fa`` once and never updated, and
    the root returned is ``b``. Each iteration works on the elements still
    active (a finished element never changes again), gathered by index;
    one host read an iteration, the count of those left."""
    def f(T, rho, e):
        _, _, mu, _, gam = _gamma_mu_at(rho, T, x_mf, tabs)
        return mu * e * (gam - 1.0) / (CGS_KB / CGS_MP) - T

    shape = e_cgs.shape
    e_cgs, rho_cgs = e_cgs.reshape(-1), rho_cgs.reshape(-1)
    a = torch.ones_like(e_cgs)
    b = torch.full_like(e_cgs, 1.0e7)
    fa, fb = f(a, rho_cgs, e_cgs), f(b, rho_cgs, e_cgs)
    sw = torch.abs(fa) < torch.abs(fb)
    a, b = torch.where(sw, b, a), torch.where(sw, a, b)
    fa, fb = torch.where(sw, fb, fa), torch.where(sw, fa, fb)
    c, fc = a.clone(), fa.clone()
    d = torch.zeros_like(e_cgs)
    mflag = torch.ones_like(e_cgs, dtype=torch.bool)
    idx = torch.arange(e_cgs.numel(), device=e_cgs.device)
    for _ in range(200):
        idx = idx[torch.abs(b[idx] - a[idx]) > delta]
        if idx.numel() == 0:
            break
        ai, bi, ci, di = a[idx], b[idx], c[idx], d[idx]
        fai, fbi, fci, mi = fa[idx], fb[idx], fc[idx], mflag[idx]
        use_iq = (fai != fci) & (fbi != fci)
        one = torch.ones_like(ai)
        s_iq = (ai * fbi * fci
                / torch.where(use_iq, (fai - fbi) * (fai - fci), one)
                + bi * fai * fci
                / torch.where(use_iq, (fbi - fai) * (fbi - fci), one)
                + ci * fai * fbi
                / torch.where(use_iq, (fci - fai) * (fci - fbi), one))
        s_sec = bi - fbi * (bi - ai) / (fbi - fai)
        s = torch.where(use_iq, s_iq, s_sec)
        q = (3.0 * ai + bi) / 4.0
        cond = (((s < torch.minimum(q, bi)) & (s > torch.maximum(q, bi)))
                | (mi & (torch.abs(s - bi) >= torch.abs(bi - ci) / 2.0))
                | (~mi & (torch.abs(s - bi) >= torch.abs(ci - di) / 2.0))
                | (mi & (torch.abs(bi - ci) < delta))
                | (~mi & (torch.abs(ci - di) < delta)))
        s = torch.where(cond, (ai + bi) / 2.0, s)
        fs = f(s, rho_cgs[idx], e_cgs[idx])
        lo = fai * fs < 0.0
        nb, nfb = torch.where(lo, s, bi), torch.where(lo, fs, fbi)
        na, nfa = torch.where(lo, ai, s), torch.where(lo, fai, fs)
        sw = torch.abs(nfa) < torch.abs(nfb)
        a[idx] = torch.where(sw, nb, na)
        b[idx] = torch.where(sw, na, nb)
        fa[idx] = torch.where(sw, nfb, nfa)
        fb[idx] = torch.where(sw, nfa, nfb)
        c[idx], d[idx] = bi, ci
        mflag[idx] = cond
    return b.reshape(shape)


@functools.lru_cache(maxsize=4)
def lookup_tables(x_mf: float, device: str = "cpu"):
    """(rho, e, mu, gamma_eff, gamma1) of the reference's lookup tables on
    the 1000 x 1000 log-spaced (rho, e) grid (reference
    src/pvte_law.cpp:370-393 ``initializeLookupTables``), float64 tensors
    on ``device``, built there once per process and hydrogen fraction."""
    lo, w, coeffs = funcdum_poly()
    tabs = (lo, w, torch.tensor(coeffs, dtype=torch.float64, device=device))
    rho_t = torch.tensor(10.0 ** (DLOG_RHO * np.arange(N_RHO)) * RHO_MIN,
                         dtype=torch.float64, device=device)
    e_t = torch.tensor(10.0 ** (DLOG_E * np.arange(N_E)) * E_MIN,
                       dtype=torch.float64, device=device)
    rho2, e2 = torch.broadcast_tensors(rho_t[:, None], e_t[None, :])
    rho2, e2 = rho2.contiguous(), e2.contiguous()
    T = _ref_brent_temperature(e2, rho2, x_mf, tabs)
    _, _, mu, _, geff = _gamma_mu_at(rho2, T, x_mf, tabs)
    g1 = gamma1_at(rho2, T, x_mf, tabs)
    return rho_t, e_t, mu, geff, g1


def lookup_gamma_mu(rho_cgs, e_cgs, tables):
    """(gamma_eff, mu, gamma1) by the reference's bilinear lookup
    (src/pvte_law.cpp:395-440): the cell found in log space with its
    indices clamped to [0, N - 2], the weights linear in (rho, e) and
    left unclamped, so a point off the table extrapolates. ``tables`` are
    in the run's dtype."""
    rho_t, e_t, mu_t, geff_t, g1_t = tables
    i = torch.floor(torch.log10(rho_cgs / RHO_MIN) / DLOG_RHO).to(torch.int64)
    j = torch.floor(torch.log10(e_cgs / E_MIN) / DLOG_E).to(torch.int64)
    i = torch.clamp(i, 0, N_RHO - 2)
    j = torch.clamp(j, 0, N_E - 2)
    x = (rho_cgs - rho_t[i]) / (rho_t[i + 1] - rho_t[i])
    y = (e_cgs - e_t[j]) / (e_t[j + 1] - e_t[j])

    def interp(tab):
        s_ij = tab[i + 1, j] * x + tab[i, j] * (1.0 - x)
        s_ijp1 = tab[i + 1, j + 1] * x + tab[i, j + 1] * (1.0 - x)
        return s_ij * (1.0 - y) + s_ijp1 * y

    return interp(geff_t), interp(mu_t), interp(g1_t)


# --------------------------------------------------------------------------
# float32 fast path: elementwise funcdum, unrolled solvers, analytic gamma1
# --------------------------------------------------------------------------

_FD_ELEM_BOUNDS = (8.0, 40.0, 130.0, 500.0, 2000.0)   # K
_FD_ELEM_DEG = 14
_FD_TAIL_DEG = 6


def _dum2_np(T):
    """Analytic vibrational contribution (reference :357-360)."""
    d1 = THETA_V / np.asarray(T, np.float64)
    return d1 * np.exp(-d1) / (1.0 - np.exp(-d1))


@functools.lru_cache(maxsize=1)
def funcdum_elem_tables():
    """Chebyshev coefficients (Python floats) of dum3 = funcdum - 1.5 -
    dum2: zero below 8 K, four degree-14 segments in ln T up to 2000 K,
    and a degree-6 fit in u = THETA_R/T above; each with the coefficients
    of its d/dlnT (tail: d/du)."""
    import numpy.polynomial.chebyshev as cheb
    n = 512
    xn = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    segs = []
    b = _FD_ELEM_BOUNDS
    for i in range(len(b) - 1):
        lo, hi = math.log(b[i]), math.log(b[i + 1])
        ln = 0.5 * (xn + 1.0) * (hi - lo) + lo
        T = np.exp(ln)
        d3 = _funcdum_exact_np(T) - 1.5 - _dum2_np(T)
        c = cheb.chebfit(xn, d3, _FD_ELEM_DEG)
        dc = cheb.chebder(c) * (2.0 / (hi - lo))
        segs.append((lo, hi, tuple(c.tolist()), tuple(dc.tolist())))
    umax = THETA_R / b[-1]
    u = np.maximum(0.5 * (xn + 1.0) * umax, 1e-12)
    T = THETA_R / u
    d3 = _funcdum_exact_np(T) - 1.5 - _dum2_np(T)
    ct = cheb.chebfit(xn, d3, _FD_TAIL_DEG)
    dct = cheb.chebder(ct) * (2.0 / umax)
    tail = (math.log(b[-1]), umax, tuple(ct.tolist()), tuple(dct.tolist()))
    return tuple(segs), tail


def _clenshaw(x, c):
    """Chebyshev series with Python-float coefficients, by Clenshaw."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    two_x = 2.0 * x
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = c[k] + two_x * b1 - b2, b1
    return c[0] + x * b1 - b2


def _funcdum_fast(t, invT, want_deriv=False):
    """funcdum(ln T) and, with ``want_deriv``, d funcdum/d lnT."""
    segs, (t_tail, umax, ct, dct) = funcdum_elem_tables()
    d1 = THETA_V * invT
    m = torch.expm1(-d1)
    dum2 = -d1 * (1.0 + m) / m
    val = torch.zeros_like(t)
    der = torch.zeros_like(t) if want_deriv else None
    for lo, hi, c, dc in segs:
        x = torch.clamp((t - lo) * (2.0 / (hi - lo)) - 1.0, -1.0, 1.0)
        sel = (t >= lo) & (t < hi)
        val = torch.where(sel, _clenshaw(x, c), val)
        if want_deriv:
            der = torch.where(sel, _clenshaw(x, dc), der)
    u = THETA_R * invT
    xt = torch.clamp(2.0 * u / umax - 1.0, -1.0, 1.0)
    sel = t >= t_tail
    val = torch.where(sel, _clenshaw(xt, ct), val)
    F = 1.5 + dum2 + val
    if not want_deriv:
        return F, None
    der = torch.where(sel, _clenshaw(xt, dct) * (-u), der)
    dd2 = dum2 * (-d1 / m - 1.0)
    return F, dd2 + der


_THX = 13.60 * CGS_EV / CGS_KB             # ionisation theta [K]
_THY = 4.48 * CGS_EV / CGS_KB              # dissociation theta [K]
_CSAHA_X = CGS_M_H * (CGS_M_E * CGS_KB / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
_CSAHA_Y = CGS_M_H / 2.0 \
    * (CGS_M_H * CGS_KB / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5


def _pvte_terms(rho, t, x_mf, want_deriv=False):
    """One elementwise evaluation at t = ln T: (T, eps) and, with
    ``want_deriv``, (deps/dlnT, mu, dmu/dlnT, dmu/dlnrho)."""
    T = torch.exp(t)
    invT = 1.0 / T
    T32 = T * torch.sqrt(T)
    ax = (_CSAHA_X / x_mf) * T32 * torch.exp(-_THX * invT) / rho
    ay = (_CSAHA_Y / x_mf) * T32 * torch.exp(-_THY * invT) / rho
    sx = torch.sqrt(1.0 + 4.0 / ax)
    sy = torch.sqrt(1.0 + 4.0 / ay)
    satx = ax >= 1e8
    saty = ay >= 1e8
    x = torch.where(satx, 1.0, 2.0 / (1.0 + sx))
    y = torch.where(saty, 1.0, 2.0 / (1.0 + sy))
    F, Fp = _funcdum_fast(t, invT, want_deriv)
    chh = 4.48 * CGS_EV * x_mf / (2.0 * CGS_KB)
    chii = 13.60 * CGS_EV * x_mf / CGS_KB
    eps = (0.5 * x_mf * (1.0 - y) * F
           + chii * x * y * invT
           + chh * y * invT
           + 0.375 * (1.0 - x_mf)
           + 1.5 * x_mf * (1.0 + x) * y)
    if not want_deriv:
        return T, eps, None
    # d x/d lnA = (s-1)/(s (1+s)), and 0 in the limit A -> 0 where s is
    # infinite: A = 0, or a subnormal A, which this side keeps and XLA's
    # CPU backend flushes to 0
    dfx = torch.where(satx | (ax <= 0.0) | torch.isinf(sx), 0.0,
                      (sx - 1.0) / (sx * (1.0 + sx)))
    dfy = torch.where(saty | (ay <= 0.0) | torch.isinf(sy), 0.0,
                      (sy - 1.0) / (sy * (1.0 + sy)))
    dx_t = dfx * (1.5 + _THX * invT)
    dy_t = dfy * (1.5 + _THY * invT)
    dx_r = -dfx
    dy_r = -dfy
    deps_t = (1.5 * x_mf * ((1.0 + x) * dy_t + y * dx_t)
              + chh * (dy_t - y) * invT
              + chii * (x * dy_t + y * dx_t - x * y) * invT
              + 0.5 * x_mf * ((1.0 - y) * Fp - F * dy_t))
    mu_den = 2.0 * x_mf * (1.0 + y + 2.0 * y * x) + 1.0 - x_mf
    mu = 4.0 / mu_den
    dden_t = 2.0 * x_mf * ((1.0 + 2.0 * x) * dy_t + 2.0 * y * dx_t)
    dden_r = 2.0 * x_mf * ((1.0 + 2.0 * x) * dy_r + 2.0 * y * dx_r)
    dmu_t = -(mu * mu / 4.0) * dden_t
    dmu_r = -(mu * mu / 4.0) * dden_r
    return T, eps, (deps_t, mu, dmu_t, dmu_r)


_LNT_HI = 7.0 * math.log(10.0)             # solve bracket [1 K, 1e7 K]


def _ln_target(e_specific_cgs):
    e_over_R = torch.clamp(e_specific_cgs * (CGS_MP / CGS_KB),
                           min=torch.finfo(e_specific_cgs.dtype).tiny)
    return e_over_R, torch.log(e_over_R)


def _temperature_fast(e_specific_cgs, rho_cgs, x_mf,
                      n_bisect: int = 13, n_illinois: int = 4):
    """The 13 + 4 bisection/Illinois solve with the elementwise funcdum.
    Returns t = ln T."""
    lo = torch.zeros_like(rho_cgs)
    hi = torch.full_like(rho_cgs, _LNT_HI)
    e_over_R, ln_target = _ln_target(e_specific_cgs)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        T, eps, _ = _pvte_terms(rho_cgs, mid, x_mf)
        take_low = T * eps > e_over_R
        lo, hi = torch.where(take_low, lo, mid), torch.where(take_low, mid, hi)

    def g(t):
        _, eps, _ = _pvte_terms(rho_cgs, t, x_mf)
        return t + torch.log(eps) - ln_target

    glo, ghi = g(lo), g(hi)
    for _ in range(n_illinois):
        w = hi - lo
        s = torch.clamp(_secant(lo, glo, hi, ghi), lo + 1e-4 * w,
                        hi - 1e-4 * w)
        gs = g(s)
        low = gs < 0.0
        lo, glo, hi, ghi = (torch.where(low, s, lo),
                            torch.where(low, gs, 0.5 * glo),
                            torch.where(low, hi, s),
                            torch.where(low, 0.5 * ghi, gs))
    return torch.clamp(_secant(lo, glo, hi, ghi), lo, hi)


def _temperature_warm(ln_target, rho_cgs, x_mf, t0, n_newton: int = 1):
    """``n_newton`` bracket-safeguarded Newton steps in t = ln T from the
    warm guess ``t0``; a step that leaves the sign bracket falls back to
    its midpoint."""
    t = torch.clamp(t0, 0.0, _LNT_HI)
    lo = torch.zeros_like(t)
    hi = torch.full_like(t, _LNT_HI)
    for _ in range(n_newton):
        _, eps, (deps_t, _, _, _) = _pvte_terms(rho_cgs, t, x_mf,
                                                want_deriv=True)
        gg = t + torch.log(eps) - ln_target
        gp = torch.clamp(1.0 + deps_t / eps, min=0.05)
        lo = torch.where(gg < 0.0, t, lo)
        hi = torch.where(gg >= 0.0, t, hi)
        tn = t - gg / gp
        # non-strict bounds: at convergence the bracket edge is the iterate
        t = torch.where((tn >= lo) & (tn <= hi), tn, 0.5 * (lo + hi))
    return t


def gamma_mu_fast(rho_cgs, e_specific_cgs, x_mf, guess=None, n_newton=1):
    """(gamma_eff, mu, gamma1): the cold solve, or the warm Newton polish
    from ``guess`` = (gamma_eff, mu) of a previous refresh; then one
    derivative evaluation gives gamma_eff and the analytic gamma1."""
    if guess is None:
        t = _temperature_fast(e_specific_cgs, rho_cgs, x_mf)
    else:
        _, ln_target = _ln_target(e_specific_cgs)
        # T = (e/R) / eps with eps = 1/(mu (gamma_eff - 1)) of the guess
        gm = torch.clamp(guess[1] * (guess[0] - 1.0),
                         min=torch.finfo(e_specific_cgs.dtype).tiny)
        t0 = ln_target + torch.log(gm)
        t = _temperature_warm(ln_target, rho_cgs, x_mf, t0, n_newton)
    _, eps, (deps_t, mu, dmu_t, dmu_r) = _pvte_terms(rho_cgs, t, x_mf,
                                                     want_deriv=True)
    gamma_eff = 1.0 + 1.0 / (mu * eps)
    chi_t = 1.0 - dmu_t / mu
    chi_r = 1.0 - dmu_r / mu
    g1 = (gamma_eff - 1.0) * eps * chi_t ** 2 / (eps + deps_t) + chi_r
    return gamma_eff, mu, g1


class PVTE:
    """Per-run PVTE evaluator: the units, the funcdum fit on the run's
    device, and the solver of the dtype (float32: the fast path,
    warm-started with ``n_newton`` Newton steps; float64: the bisection
    pipeline). ``refreshes`` counts the calls of ``gamma_mu``."""

    def __init__(self, phys, units, dtype: torch.dtype, device=None,
                 n_newton: int = 1):
        self.x_mf = phys.hydrogen_mass_fraction
        lo, w, coeffs = funcdum_poly()
        self.tabs = (lo, w, torch.tensor(coeffs, dtype=dtype, device=device))
        self.units = units
        self.density_factor = phys.density_factor
        self.shock_tube = phys.shock_tube
        self.lookup = bool(phys.pvte_lookup_table)
        self.tables = None
        if self.lookup:
            # the reference's tables, cast to the run's dtype
            dev = str(torch.device(device if device is not None else "cpu"))
            self.tables = tuple(t.to(dtype) for t in
                                lookup_tables(self.x_mf, dev))
        self.fast = dtype == torch.float32 and not self.lookup
        self.n_newton = int(n_newton)
        self.refreshes = 0

    def gamma_mu(self, sigma, energy, scale_height, guess=None):
        """(gamma_eff, mu, gamma1) grids of the state (reference :497-541
        ``compute_gamma_mu``); ``guess`` warm-starts the float32 solve. A
        shock tube takes Sigma for the volume density, no scale height
        (reference :521-524)."""
        self.refreshes += 1
        un = self.units
        if self.shock_tube > 0:
            rho_cgs = sigma * un.density
        else:
            rho_cgs = sigma / (self.density_factor * scale_height) \
                * un.density
        e_spec_cgs = energy / sigma * (un.energy_density / un.surface_density)
        if self.lookup:
            return lookup_gamma_mu(rho_cgs, e_spec_cgs, self.tables)
        if self.fast:
            return gamma_mu_fast(rho_cgs, e_spec_cgs, self.x_mf, guess=guess,
                                 n_newton=self.n_newton)
        T = temperature_from_energy(e_spec_cgs, rho_cgs, self.x_mf, self.tabs)
        _, _, mu, _, gamma_eff = _gamma_mu_at(rho_cgs, T, self.x_mf,
                                              self.tabs)
        g1 = gamma1_at(rho_cgs, T, self.x_mf, self.tabs)
        return gamma_eff, mu, g1

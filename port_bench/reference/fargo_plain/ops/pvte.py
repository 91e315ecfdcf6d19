"""PVTE equation of state: the variable effective adiabatic index of
hydrogen ionisation and dissociation (Vaidya et al. 2015; D'Angelo et al.
2013; reference src/pvte_law.cpp).

The temperature is solved per cell from the specific energy and the
midplane density; every ingredient (the Saha fractions, the H2 internal
energy ``funcdum``) is closed-form elementwise math. The float64 solver
of ``fargocpt_tpu.ops.pvte``: 48 bisection halvings of log10 T on [1,
1e7] K with the piecewise-Chebyshev ``funcdum`` (32 segments, degree 10)
and gamma1 by finite differences (``temperature_from_energy``,
``gamma1_at``). The port's float32 solver and its lookup tables are not
in this copy (``scope.py``).
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


def temperature_from_energy(e_specific_cgs, rho_cgs, x_mf, tabs,
                            n_iter: int | None = None):
    """Invert e(T, rho) = e_specific on [1, 1e7] K: the bisection of
    log10 T, 48 halvings by default."""
    if n_iter is None:
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


class PVTE:
    """Per-run PVTE evaluator: the units, the funcdum fit on the run's
    device, and the bisection pipeline. ``refreshes`` counts the calls of
    ``gamma_mu``."""

    def __init__(self, phys, units, dtype: torch.dtype, device=None):
        self.x_mf = phys.hydrogen_mass_fraction
        lo, w, coeffs = funcdum_poly()
        self.tabs = (lo, w, torch.tensor(coeffs, dtype=dtype, device=device))
        self.units = units
        self.density_factor = phys.density_factor
        self.refreshes = 0

    def gamma_mu(self, sigma, energy, scale_height):
        """(gamma_eff, mu, gamma1) grids of the state (reference :497-541
        ``compute_gamma_mu``)."""
        self.refreshes += 1
        un = self.units
        rho_cgs = sigma / (self.density_factor * scale_height) * un.density
        e_spec_cgs = energy / sigma * (un.energy_density / un.surface_density)
        T = temperature_from_energy(e_spec_cgs, rho_cgs, self.x_mf, self.tabs)
        _, _, mu, _, gamma_eff = _gamma_mu_at(rho_cgs, T, self.x_mf,
                                              self.tabs)
        g1 = gamma1_at(rho_cgs, T, self.x_mf, self.tabs)
        return gamma_eff, mu, g1

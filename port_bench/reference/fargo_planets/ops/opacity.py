"""Opacity laws (reference src/opacity.cpp): Lin & Papaloizou (1985) and
Bell & Lin (1994) piecewise power-law fits with smoothed transitions, plus
the constant and kappa0 T^2 laws. Every branch is evaluated and selected
with ``torch.where``.

The regime conditions compare in log space (``lnT > c + p lnrho``), the
fractional powers share one ``log(rho)`` through ``exp(a lnrho)``, and
``x ** 0.25`` is two square roots, as in ``fargocpt_tpu.ops.opacity``.
Inputs and outputs are in code units; the fits are in cgs internally.
"""

from __future__ import annotations

import math

import torch

from ..params import Physics


def _q25(x):
    """x ** 0.25 for x >= 0 as two square roots."""
    return torch.sqrt(torch.sqrt(x))


def _sq(x):
    return x * x


def _lin_cgs(rho, T):
    """Lin & Papaloizou 1985 (reference src/opacity.cpp:37-133)."""
    power1, power2, power3 = 4.44444444e-2, 2.381e-2, 2.267e-1
    t234, t456, t678 = 1.6e3, 5.7e3, 2.28e6
    ak1, ak2, ak3 = 2.0e-4, 2.0e16, 5.0e-3
    bk3, bk4, bk5, bk6, bk7, bk8 = 50.0, 2.0e-2, 2.0e4, 1.0e4, 1.5e10, 0.348

    lnT = torch.log(T)
    lnr = torch.log(rho)

    # low-temperature branch (regions 1-3)
    t2 = T * T
    t4 = t2 * t2
    t8 = t4 * t4
    t10 = t8 * t2
    o1 = ak1 * t2
    o2 = ak2 * T / t8
    o3l = ak3 * T
    o1an = o1 * o1
    o2an = o2 * o2
    k_low = _q25(_sq(o1an * o2an / (o1an + o2an))
                 + _sq(_sq(o3l / (1.0 + 1.0e22 / t10))))

    # high-temperature branches
    ts4 = 1.0e-4 * T
    rho13 = torch.exp(lnr * (1.0 / 3.0))
    rho23 = rho13 * rho13
    ts42 = ts4 * ts4
    ts44 = ts42 * ts42
    ts48 = ts44 * ts44

    # regions 3-5
    o3 = bk3 * ts4
    o4 = bk4 * rho23 / (ts48 * ts4)
    o5 = bk5 * rho23 * ts42 * ts4
    o4an = _sq(_sq(o4))
    o3an = _sq(_sq(o3))
    k_345 = _q25((o4an * o3an / (o4an + o3an))
                 + _sq(_sq(o5 / (1.0 + 6.561e-5 / ts48))))

    # regions 5-7
    o6 = bk6 * rho13 * ts48 * ts42
    o7 = bk7 * rho / (ts42 * torch.sqrt(ts4))
    o6an = o6 * o6
    o7an = o7 * o7
    w = ts4 / (1.1 * torch.exp(0.04762 * lnr))
    w2 = w * w
    w10 = _sq(_sq(w2)) * w2
    k_567 = _q25(_sq(o6an * o7an / (o6an + o7an))
                 + _sq(_sq(o5 / (1.0 + w10))))

    # regions 7-8
    o8an = bk8 * bk8
    k_78 = _q25(o7an * o7an + o8an * o8an)

    k_high2 = torch.where((lnT < math.log(t678) + power3 * lnr)
                          | (rho <= 1e-10), k_567, k_78)
    k_high = torch.where(lnT > math.log(t456) + power2 * lnr, k_high2, k_345)
    return torch.where(lnT > math.log(t234) + power1 * lnr, k_high, k_low)


def opacity(phys: Physics, units, rho, T):
    """kappa(rho, T) in code units (reference src/opacity.cpp:8-32)."""
    mode = phys.opacity_mode
    if mode.startswith("const"):
        kappa = phys.kappa_const
    elif mode == "simple":
        kappa = phys.kappa_const * (T * units.temperature) ** 2
    else:
        if mode == "bell":
            raise ValueError("the benchmark's reference has no Bell opacity")
        kappa = _lin_cgs(rho * units.density, T * units.temperature) \
            / units.opacity
    return phys.kappa_factor * kappa

"""Disk self-gravity by FFT convolution on the logarithmic polar grid
(Baruteau & Masset 2008; reference src/selfgravity.cpp).

With u = ln(r/r0) the smoothed acceleration is a 2-D circular convolution
of S_r = Sigma e^{u/2} and S_t = Sigma e^{3u/2} with kernels K_r, K_t on a
radially doubled (2 NR, NAZ) grid. Here it is ``torch.fft.rfft2``, a
product with the kernel spectra and ``irfft2``, in complex64 for float32
runs and complex128 for float64. The smoothing modes ``basic`` (Baruteau
2008) and ``symmetric`` (Moldenhauer 2018); the port's ``besselkernel``
(Rendon Restrepo 2023) is not in this copy (``scope.py``).

The adiabatic kernel refresh (reference :186-214) is due every
``SelfGravityKernelUpdateInterval`` calls. Its call counter is a host
integer, so only a due call reads the device: one read of whether the
mass-weighted aspect ratio moved past the threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Geometry, LOGARITHMIC
from ..params import Physics
from .common import Geom

SMOOTHING_MODES = ("basic", "b", "symmetric", "s")
BESSEL_MODES = ("besselkernel", "bk")


def _doubled_grid_uth(geometry: Geometry):
    """(u, theta) columns of the radially doubled kernel grid."""
    nr, naz = geometry.nrad, geometry.naz
    radii = geometry.radii_ext
    i = np.arange(2 * nr)
    u = np.where(i < nr,
                 np.log(radii[np.minimum(i, nr)] / radii[0]),
                 -np.log(radii[np.minimum(2 * nr - i, nr)] / radii[0]))
    theta = geometry.dphi * np.arange(naz)
    return u[:, None], theta[None, :]


def _kernel_bs(phys: Physics, U, TH, aspect_ratio, xp):
    """K_r, K_t of the basic and symmetric smoothing modes; ``xp`` is numpy
    (the host build) or torch (the in-run rebuild with a device aspect
    ratio)."""
    if phys.self_gravity_mode in ("basic", "b"):
        eps = phys.thickness_smoothing_sg * aspect_ratio
        denom = (eps * eps * xp.exp(U)
                 + 2.0 * (xp.cosh(U) - xp.cos(TH))) ** -1.5
        k_r = (1.0 + eps * eps - xp.cos(TH) * xp.exp(-U)) * denom
        k_t = xp.sin(TH) * denom
    else:
        # Moldenhauer 2018 fits (reference :171-179)
        lam_sq = (0.4571 * aspect_ratio
                  + 0.6737 * xp.sqrt(aspect_ratio)) ** 2
        chi_sq = ((-0.7543 * aspect_ratio + 0.6472) * aspect_ratio) ** 2
        denom = (2.0 * (xp.cosh(U) - xp.cos(TH))
                 + lam_sq * (xp.exp(U) + xp.exp(-U) - 2.0) + chi_sq) ** -1.5
        k_r = (1.0 - xp.cos(TH) * xp.exp(-U)) * denom
        k_t = xp.sin(TH) * denom
    return k_r, k_t


def kernel_host(phys: Physics, geometry: Geometry, aspect_ratio: float
                ) -> tuple[np.ndarray, np.ndarray]:
    """K_r, K_t on the doubled grid, float64 on the host (reference
    src/selfgravity.cpp:418-519 ``compute_FFT_kernel``)."""
    U, TH = _doubled_grid_uth(geometry)
    mode = phys.self_gravity_mode
    if mode in SMOOTHING_MODES:
        return _kernel_bs(phys, U, TH, aspect_ratio, np)
    raise ValueError(f"SelfGravityMode {mode!r} is not in the benchmark's "
                     "reference")


class SelfGravity:
    """The FFT-convolution solver of one configuration; its tensors live
    on ``device``."""

    def __init__(self, phys: Physics, constants, geometry: Geometry,
                 dtype: torch.dtype, device=None):
        if geometry.spacing != LOGARITHMIC:
            raise ValueError("self-gravity requires a logarithmic radial "
                             "grid (reference src/selfgravity.cpp:219-227)")
        self.phys = phys
        self.constants = constants
        self.geometry = geometry
        self.dtype = dtype
        nr = geometry.nrad
        # reference :246: r_step = ln(Radii[NR]/Radii[0]) / NR
        self.r_step = float(np.log(geometry.radii[nr] / geometry.radii[0])
                            / nr)
        self.t_step = geometry.dphi
        s = np.sqrt(geometry.rmed / geometry.rmed[0])
        self.scale_half = torch.tensor(s[:, None], dtype=dtype, device=device)
        self.scale_3half = torch.tensor(
            (s * geometry.rmed / geometry.rmed[0])[:, None], dtype=dtype,
            device=device)
        self.cdtype = torch.complex64 if dtype == torch.float32 \
            else torch.complex128
        U, TH = _doubled_grid_uth(geometry)
        self.U = torch.tensor(U, dtype=dtype, device=device)
        self.TH = torch.tensor(TH, dtype=dtype, device=device)
        k_r, k_t = kernel_host(phys, geometry, phys.aspectratio_ref)
        # host FFT in float64, spectra cast to the compute type
        cnp = np.complex64 if dtype == torch.float32 else np.complex128
        self.k_r_hat = torch.tensor(np.fft.rfft2(k_r).astype(cnp),
                                    device=device)
        self.k_t_hat = torch.tensor(np.fft.rfft2(k_t).astype(cnp),
                                    device=device)
        self.rebuilds = 0

    # ------- in-run kernel update (reference selfgravity.cpp:186-214) -----
    def supports_in_run_update(self) -> bool:
        """Whether the run rebuilds the kernel from the disk's aspect ratio:
        the basic and symmetric modes; the Bessel kernel stays as built
        (fargocpt_tpu/ops/selfgravity.py:184-190)."""
        return self.phys.self_gravity_mode in SMOOTHING_MODES

    def initial_kernel_state(self):
        """(k_r_hat, k_t_hat, last_aspect_ratio, since_last): the counter
        starts at the interval so the first call is due, the last aspect
        ratio at 0 so the threshold test passes (reference :192-210)."""
        return (self.k_r_hat, self.k_t_hat,
                torch.zeros((), dtype=self.dtype,
                            device=self.k_r_hat.device),
                int(self.phys.sg_kernel_update_interval))

    def update_kernel(self, kstate, sigma, scale_height, g: Geom,
                      row_w=None, comm=None):
        """On every Nth call, rebuild the kernel spectra if the
        mass-averaged aspect ratio moved by more than the threshold
        (reference :186-214 + quantities.cpp:107-140). Sharded, ``row_w``
        is the window's column of owned rows and ``comm`` sums the mass
        average's parts over the ranks (fargocpt_tpu/ops/selfgravity.py:
        203-222), so every rank takes the same decision."""
        k_r_hat, k_t_hat, last_ar, since = kstate
        phys = self.phys
        due = since >= phys.sg_kernel_update_interval - 1
        since = 0 if due else since + 1
        if not due:
            return (k_r_hat, k_t_hat, last_ar, since)
        inside = g.rb <= self.geometry.rmax
        w = sigma * g.surf
        if row_w is not None:
            w = w * row_w
        w = torch.where(inside, w, 0.0)
        q_m = torch.stack([torch.sum(scale_height * g.inv_rb * w),
                           torch.sum(w)])
        if comm is not None:
            q_m = comm.sum(q_m)
        ar_avg = q_m[0] / q_m[1]
        # safety net (reference :158-161)
        ar_avg = torch.where(ar_avg == 0.0, phys.aspectratio_ref, ar_avg)
        if not bool(torch.abs(last_ar - ar_avg)
                    >= phys.sg_kernel_aspectratio_threshold):
            return (k_r_hat, k_t_hat, last_ar, since)
        self.rebuilds += 1
        k_r, k_t = _kernel_bs(phys, self.U, self.TH, ar_avg, torch)
        return (torch.fft.rfft2(k_r).to(self.cdtype),
                torch.fft.rfft2(k_t).to(self.cdtype), ar_avg, since)

    def accelerations(self, sigma, spectra=None):
        """g_r, g_phi at the cell centres (reference :321-700); ``spectra``
        are the carried kernel spectra, when the run updates them."""
        nr, naz = self.geometry.nrad, self.geometry.naz
        k_r_hat, k_t_hat = spectra if spectra is not None \
            else (self.k_r_hat, self.k_t_hat)
        pad = torch.zeros_like(sigma)
        s_r = torch.cat([sigma * self.scale_half, pad], dim=0)
        s_t = torch.cat([sigma * self.scale_3half, pad], dim=0)
        acc_r = torch.fft.irfft2(k_r_hat * torch.fft.rfft2(s_r),
                                 s=(2 * nr, naz))[:nr]
        acc_t = torch.fft.irfft2(k_t_hat * torch.fft.rfft2(s_t),
                                 s=(2 * nr, naz))[:nr]
        norm = -self.constants.G * self.r_step * self.t_step
        return norm * acc_r / self.scale_half, norm * acc_t / self.scale_3half

    def kick(self, g: Geom, vrad, vaz, g_r, g_t, dt):
        """Velocity update from the accelerations (reference :712-747):
        g_r interpolated to the faces 1..NR-1, g_phi averaged to the
        azimuthal interfaces."""
        nr = g.nrad
        w_hi = (g.ra[1:nr] - g.rb[:-1]) * g.inv_diff_rmed[1:nr]
        w_lo = (g.rb[1:] - g.ra[1:nr]) * g.inv_diff_rmed[1:nr]
        dvr = dt * (w_hi * g_r[1:] + w_lo * g_r[:-1])
        vrad = torch.cat([vrad[:1], vrad[1:nr] + dvr, vrad[nr:]], dim=0)
        vaz = vaz + 0.5 * dt * (g_t + torch.roll(g_t, 1, dims=-1))
        return vrad, vaz

    def init_azimuthal_velocity_correction(self, phys: Physics, sigma,
                                           vaz: np.ndarray) -> np.ndarray:
        """Equilibrium v_az with the axisymmetric self-gravity pull
        (reference :749-781, Baruteau 2008 eq. 3.42); host numpy."""
        from .diskmodel import v_az_smoothed
        g_r, _ = self.accelerations(sigma)
        g_r_axi = g_r.mean(dim=-1).cpu().numpy()
        rb = self.geometry.rmed
        omega_cell = v_az_smoothed(phys, self.constants, rb,
                                   phys.hydro_center_mass) / rb
        omega = np.sqrt(np.maximum(omega_cell ** 2 - g_r_axi / rb, 0.0))
        out = vaz.copy()
        nr = self.geometry.nrad
        out[:nr - 1] = (rb * omega)[:nr - 1, None]
        return out

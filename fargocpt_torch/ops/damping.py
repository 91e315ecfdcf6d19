"""Wave-damping zones (de Val-Borro et al. 2006; reference
src/boundary_conditions/damping.cpp:311-700, the JAX package's
``fargocpt_tpu/ops/damping.py``): inside the inner zone r < RMIN * L_in
(the outer zone r > RMAX * L_out) every selected quantity relaxes toward
its target at the rate exp(-dt ramp(r)^2 / tau), tau = f 2 pi /
Omega_K(edge).

Targets: initial (reference) values, the azimuthal mean, zero, none, and
for the inner v_rad the viscous drift. The rates and masks are per-ring
columns built once from the geometry, so one application is a few
elementwise ops per field.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..params import Physics
from .boundary import RefValues


class DampingZones(nn.Module):
    """The damping columns of one configuration; buffers, so ``.to``
    moves them."""

    def __init__(self, phys: Physics, constants, geometry, dtype,
                 device=None):
        super().__init__()
        self.phys = phys
        rmin, rmax = geometry.rmin, geometry.rmax
        gm = constants.G * phys.hydro_center_mass
        # tau of the inner edge from Omega_K(RMIN), of the outer from
        # Omega_K(DampingTimeRadiusOuter), RMAX by default
        tau_in = phys.damping_time_factor * 2.0 * np.pi \
            / np.sqrt(gm / rmin ** 3)
        r_tau_out = phys.damping_time_radius_outer \
            if phys.damping_time_radius_outer > 0.0 else rmax
        tau_out = phys.damping_time_factor * 2.0 * np.pi \
            / np.sqrt(gm / r_tau_out ** 3)
        r_in = rmin * phys.damping_inner_limit
        r_out = rmax * phys.damping_outer_limit

        def cols(radius, suffix):
            rate = np.zeros_like(radius)
            inner = np.zeros_like(radius, bool)
            outer = np.zeros_like(radius, bool)
            if phys.damping_inner_limit > 1.0:
                inner = radius < r_in
                rate = np.where(
                    inner, ((radius - r_in) / (rmin - r_in)) ** 2 / tau_in,
                    rate)
            if phys.damping_outer_limit < 1.0:
                outer = radius > r_out
                rate = np.where(
                    outer, ((radius - r_out) / (rmax - r_out)) ** 2
                    / tau_out, rate)
            self.register_buffer(f"rate_{suffix}", torch.tensor(
                rate[:, None], dtype=dtype, device=device))
            self.register_buffer(f"in_{suffix}", torch.tensor(
                inner[:, None], device=device))
            self.register_buffer(f"out_{suffix}", torch.tensor(
                outer[:, None], device=device))

        # scalar rings sit at Rb, v_rad faces at Ra (reference :314-315)
        cols(geometry.rmed, "b")
        cols(geometry.ra[:geometry.nrad + 1], "a")
        self.register_buffer("inv_ra", torch.tensor(
            1.0 / geometry.ra[:geometry.nrad + 1, None], dtype=dtype,
            device=device))

    @staticmethod
    def _damp(x, x0_inner, x0_outer, rate, in_mask, out_mask, dt,
              mode_inner: str, mode_outer: str):
        if mode_inner == mode_outer == "none":
            return x            # no zone damps it: x, and no launch
        e = torch.exp(-dt * rate)
        x0 = torch.where(in_mask, x0_inner, x0_outer)
        active = torch.zeros_like(in_mask)
        if mode_inner != "none":
            active = active | in_mask
        if mode_outer != "none":
            active = active | out_mask
        return torch.where(active, (x - x0) * e + x0, x)

    @staticmethod
    def _target(mode: str, x, x0):
        if mode in ("initial", "reference", "none"):
            return x0
        if mode == "mean":
            return torch.mean(x, dim=-1, keepdim=True).expand_as(x)
        if mode == "zero":
            return torch.zeros_like(x)
        raise NotImplementedError(f"damping target {mode!r}")

    def _viscous_vrad_target(self, phys: Physics, nu):
        """The viscous drift -1.5 s nu / Rinf, nu averaged onto the radial
        faces (reference src/boundary_conditions/damping.cpp:623-678)."""
        nu_face = torch.cat([nu[:1], 0.5 * (nu[1:] + nu[:-1]), nu[-1:]],
                            dim=0)
        return -1.5 * phys.viscous_outflow_speed * nu_face * self.inv_ra

    def apply(self, phys: Physics, sigma, vrad, vaz, energy,
              ref: RefValues, dt, nu=None):
        """reference src/boundary_conditions/damping.cpp ``damping()``.
        Returns (sigma, vrad, vaz, energy)."""
        p = phys

        def scalar(x, x0, mi, mo):
            return self._damp(x, self._target(mi, x, x0),
                              self._target(mo, x, x0), self.rate_b,
                              self.in_b, self.out_b, dt, mi, mo)

        sigma = scalar(sigma, ref.sigma0, p.damping_surface_density_inner,
                       p.damping_surface_density_outer)
        energy = scalar(energy, ref.energy0, p.damping_energy_inner,
                        p.damping_energy_outer)
        vaz = scalar(vaz, ref.vaz0, p.damping_vazimuthal_inner,
                     p.damping_vazimuthal_outer)
        mi, mo = p.damping_vradial_inner, p.damping_vradial_outer
        if mo == "viscous":
            # the reference's hard error (damping.cpp:124-127)
            raise NotImplementedError(
                "Damping vrad to viscous radial speed at the outer "
                "boundary is not implemented (as in the reference)")
        if mi == "viscous":
            if nu is None:
                raise ValueError("viscous vrad damping needs the viscosity "
                                 "grid")
            ti = self._viscous_vrad_target(p, nu)
        else:
            ti = self._target(mi, vrad, ref.vrad0)
        to = self._target(mo, vrad, ref.vrad0)
        vrad = self._damp(vrad, ti, to, self.rate_a, self.in_a, self.out_a,
                          dt, mi, mo)
        return sigma, vrad, vaz, energy

    def mass_deltas(self, g, sig_before, sig_after) -> torch.Tensor:
        """The (4,) mass the zones created and removed: inner creation,
        inner removal, outer creation, outer removal (the JAX package's
        ``_apply_bcs`` ``want_damping_delta``)."""
        dm = (sig_after - sig_before) * g.surf
        zero = torch.zeros_like(dm)
        din = torch.where(self.in_b, dm, zero)
        dout = torch.where(self.out_b, dm, zero)
        return torch.stack([torch.sum(torch.clamp(din, min=0.0)),
                            torch.sum(torch.clamp(-din, min=0.0)),
                            torch.sum(torch.clamp(dout, min=0.0)),
                            torch.sum(torch.clamp(-dout, min=0.0))])

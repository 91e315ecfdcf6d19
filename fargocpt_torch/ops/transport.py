"""FARGO transport: operator-split van Leer upwind advection with the
fast-orbital-advection azimuthal splitting (Masset 2000), reference
src/TransportEuler.cpp:112-685.

All advected quantities (radial/angular momenta, energy, density) are
stacked into one (K, NR, NAZ) tensor so each sweep is one batched pass;
every quantity divides by the same pre-sweep density snapshot. The
per-ring integer-cell roll of the FARGO trick is a ``torch.gather``.
"""

from __future__ import annotations

import torch

from ..params import Physics
from .common import Geom, flux_limiter


def _next(x):
    return torch.roll(x, -1, dims=-1)


def _prev(x):
    return torch.roll(x, 1, dims=-1)


def star_radial(phys: Physics, g: Geom, q: torch.Tensor, vrad: torch.Tensor,
                dt) -> torch.Tensor:
    """Upwind face values of cell-centered q (reference
    src/TransportEuler.cpp:349-406). q: (..., NR, NAZ); vrad: (NR+1, NAZ).
    Returns (..., NR+1, NAZ) with face rows 0 and NR zero."""
    nr = g.nrad
    kind = phys.flux_limiter_type
    dqm = (q[..., 1:-1, :] - q[..., :-2, :]) * g.inv_diff_rmed[1:nr - 1]
    dqp = (q[..., 2:, :] - q[..., 1:-1, :]) * g.inv_diff_rmed[2:nr]
    dq_mid = flux_limiter(dqp, dqm, kind)
    zrow = torch.zeros_like(q[..., :1, :])
    dq = torch.cat([zrow, dq_mid, zrow], dim=-2)

    rme = g.rmed_ext
    dr_minus = rme[1:nr] - rme[:nr - 1]
    dr_plus = rme[2:nr + 1] - rme[1:nr]
    vf = vrad[1:nr]
    up = q[..., :-1, :] + (dr_minus - vf * dt) * 0.5 * dq[..., :-1, :]
    dn = q[..., 1:, :] - (dr_plus + vf * dt) * 0.5 * dq[..., 1:, :]
    qs_mid = torch.where(vf > 0.0, up, dn)
    zface = torch.zeros_like(qs_mid[..., :1, :])
    return torch.cat([zface, qs_mid, zface], dim=-2)


def star_theta(phys: Physics, g: Geom, q: torch.Tensor, v: torch.Tensor,
               dt) -> torch.Tensor:
    """Azimuthal upwind interface values (reference
    src/TransportEuler.cpp:416-466); interface j sits between cells j-1
    and j."""
    kind = phys.flux_limiter_type
    dxtheta = g.dphi * g.rb
    dq = 0.5 * flux_limiter(_next(q) - q, q - _prev(q), kind) / dxtheta
    ksi = v * dt
    up = _prev(q) + (dxtheta - ksi) * _prev(dq)
    dn = q - (dxtheta + ksi) * dq
    return torch.where(ksi > 0.0, up, dn)


def van_leer_radial_batch(phys: Physics, g: Geom, qs, sig_int, density_star,
                          vrad, dt):
    """Advect a stack radially in specific form (reference
    src/TransportEuler.cpp:545-620). Returns (qs_new, face_flux)."""
    qrstar = star_radial(phys, g, qs / sig_int, vrad, dt)
    flux = dt * g.dphi * g.ra * qrstar * density_star * vrad
    qs_new = qs + (flux[..., :-1, :] - flux[..., 1:, :]) * g.inv_surf
    return qs_new, flux


def van_leer_theta_batch(phys: Physics, g: Geom, qs, sig_int, density_star,
                         v, dt):
    """Advect a stack azimuthally in specific form (reference
    src/TransportEuler.cpp:630-664)."""
    qrstar = star_theta(phys, g, qs / sig_int, v, dt)
    f = (g.rsup - g.rinf) * dt * qrstar * density_star * v
    return qs + (f - _next(f)) * g.inv_surf


def advect_shift(q: torch.Tensor, nshift: torch.Tensor) -> torch.Tensor:
    """Exact integer-cell azimuthal roll per ring (reference
    src/TransportEuler.cpp:238-268 ``AdvectSHIFT``):
    out[.., i, j] = q[.., i, (j - s_i) mod NAZ]."""
    naz = q.shape[-1]
    j = torch.arange(naz, device=q.device)
    idx = torch.remainder(j[None, :] - nshift[:, None].to(j.dtype), naz)
    return torch.gather(q, -1, idx.expand_as(q))


def compute_momenta(g: Geom, sigma, vrad, vaz, omega_frame):
    """reference src/TransportEuler.cpp:471-493."""
    corot = g.rb * omega_frame
    return (sigma * vrad[1:], sigma * vrad[:-1],
            sigma * (_next(vaz) + corot) * g.rb,
            sigma * (vaz + corot) * g.rb)


def velocities_from_momenta(g: Geom, sigma, rp, rm, ap, am, vrad_old,
                            omega_frame):
    """reference src/TransportEuler.cpp:498-535; v_rad row 0 is zeroed and
    row NR keeps its previous value."""
    nr = g.nrad
    vr_mid = (rp[:-1] + rm[1:]) / (sigma[:-1] + sigma[1:])
    vrad = torch.cat([torch.zeros_like(vr_mid[:1]), vr_mid, vrad_old[nr:]],
                     dim=0)
    vaz = (_prev(ap) + am) / (_prev(sigma) + sigma) * g.inv_rb \
        - g.rb * omega_frame
    return vrad, vaz


def fargo_shift(g: Geom, vaz, dt):
    """Per-ring FARGO split of the mean azimuthal motion: the azimuthal
    mean ``vmean`` (NR,1), the integer cell shift ``nshift`` (NR,) and the
    residual uniform velocity ``vconst`` (NR,1). The integer part rounds
    half up (floor(x + 0.5)), as the reference does."""
    vmean = torch.mean(vaz, dim=-1, keepdim=True)
    ntilde = vmean * g.inv_rb * dt * g.invdphi
    nround = torch.floor(ntilde + 0.5)
    nshift = nround.to(torch.int32)[:, 0]
    vconst = (ntilde - nround) * g.rb * g.dphi / dt
    return vmean, nshift, vconst


def transport(phys: Physics, g: Geom, sigma, vrad, vaz, energy,
              omega_frame, dt, shift=None):
    """Full FARGO transport substep (reference src/TransportEuler.cpp:112-136).
    ``shift`` is the (vmean, nshift, vconst) triple of ``fargo_shift``;
    callers that compare two implementations pass the same one to both.
    Returns (sigma, vrad, vaz, energy, mass_flux) with mass_flux the
    radial mass flux through the faces, (NR+1, NAZ)."""
    adiabatic = phys.is_adiabatic
    k_sigma = 5 if adiabatic else 4
    if shift is None:
        shift = fargo_shift(g, vaz, dt)
    vmean, nshift, vconst = shift

    density_star = star_radial(phys, g, sigma, vrad, dt)
    rp, rm, ap, am = compute_momenta(g, sigma, vrad, vaz, omega_frame)
    names = [rp, rm, ap, am] + ([energy] if adiabatic else []) + [sigma]
    qs = torch.stack(names, dim=0)
    qs, flux = van_leer_radial_batch(phys, g, qs, sigma, density_star,
                                     vrad, dt)
    mass_flux = flux[k_sigma]

    vres = vaz - vmean
    if phys.fast_transport:
        passes = [vres, vconst.expand_as(vres)]
    else:
        passes = [vres + vconst]
    for v in passes:
        sig_now = qs[k_sigma]
        ds = star_theta(phys, g, sig_now, v, dt)
        qs = van_leer_theta_batch(phys, g, qs, sig_now, ds, v, dt)
    qs = advect_shift(qs, nshift)

    if adiabatic:
        energy = qs[4]
    sigma = qs[k_sigma]
    vrad, vaz = velocities_from_momenta(g, sigma, qs[0], qs[1], qs[2],
                                        qs[3], vrad, omega_frame)
    return sigma, vrad, vaz, energy, mass_flux

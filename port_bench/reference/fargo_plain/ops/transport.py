"""FARGO transport: operator-split van Leer upwind advection with the
fast-orbital-advection azimuthal splitting (Masset 2000), reference
src/TransportEuler.cpp:112-685.

All advected quantities (radial/angular momenta, energy, density) are
stacked into one (K, NR, NAZ) tensor so each sweep is one batched pass;
every quantity divides by the same pre-sweep density snapshot. The
per-ring integer-cell roll of the FARGO trick is a ``torch.gather``.

The whole transport (``transport``): the radial sweep of the batch, the
azimuthal half (``fargo_theta``) and the velocities, as in the JAX package
(fargocpt_tpu/ops/transport.py:164-279). The port's split and staged
routes are not in this copy (``scope.py``).
"""

from __future__ import annotations

from functools import partial

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
    f = g.dxrad * dt * qrstar * density_star * v
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


def route(nrad: int) -> str:
    """The transport route a grid with ``nrad`` rings takes by itself:
    ``"whole"``, whatever NR. The JAX package sends NR off a multiple of 16
    to its split route (fargocpt_tpu/ops/transport.py:183-191), but 16 is
    the row tile of its whole-transport TPU kernel; like that kernel's
    other conditions (float32 only, NAZ a multiple of 128) it is not
    carried over: the CUDA kernel takes any NR, NAZ and dtype."""
    return "whole"


def momenta_batch(phys: Physics, g: Geom, sigma, vrad, vaz, energy,
                  omega_frame):
    """The advected batch [rp, rm, ap, am, (energy), sigma], (K, NR, NAZ):
    K = 6 adiabatic, 5 isothermal; entry K-1 is the density."""
    rp, rm, ap, am = compute_momenta(g, sigma, vrad, vaz, omega_frame)
    names = [rp, rm, ap, am] + ([energy] if phys.is_adiabatic else []) \
        + [sigma]
    return torch.stack(names, dim=0)


def theta_sweep(phys: Physics, g: Geom, qs, v, dt):
    """One azimuthal sweep of the (K, NR, NAZ) batch with the velocity
    ``v`` (NR, NAZ) (fargocpt_tpu/ops/pallas_kernels.py
    ``theta_sweep_pallas``). Entry K-1 is the density: every quantity is
    divided by it and advected with its upwind value."""
    sig_now = qs[-1]
    ds = star_theta(phys, g, sig_now, v, dt)
    return van_leer_theta_batch(phys, g, qs, sig_now, ds, v, dt)


def fargo_theta(phys: Physics, g: Geom, qs, vres, vconst, nshift, dt,
                two_pass: bool, sweep=None, roll=None):
    """The azimuthal half of the transport
    (fargocpt_tpu/ops/pallas_kernels.py ``fargo_theta_pallas``): a sweep
    of the (K, NR, NAZ) batch with the residual velocity ``vres``, with
    ``two_pass`` a second sweep with the uniform ``vconst`` (NR, 1)
    expanded to (NR, NAZ), then the per-ring integer roll by ``nshift``.
    Each sweep takes its density from the batch as the sweep before left
    it. ``sweep`` and ``roll`` stand in for ``theta_sweep`` (without its
    first two arguments) and ``advect_shift``."""
    sweep = sweep or partial(theta_sweep, phys, g)
    roll = roll or advect_shift
    passes = [vres, vconst.expand_as(vres).contiguous()] if two_pass \
        else [vres]
    for v in passes:
        qs = sweep(qs, v, dt)
    return roll(qs, nshift)


def transport(phys: Physics, g: Geom, sigma, vrad, vaz, energy,
              omega_frame, dt, shift=None):
    """Full FARGO transport substep (reference src/TransportEuler.cpp:112-136).
    ``shift`` is the (vmean, nshift, vconst) triple of ``fargo_shift``;
    callers that compare two implementations pass the same one to both.
    Returns (sigma, vrad, vaz, energy, mass_flux) with mass_flux the
    radial mass flux through the faces, (NR+1, NAZ)."""
    density_star = star_radial(phys, g, sigma, vrad, dt)
    qs = momenta_batch(phys, g, sigma, vrad, vaz, energy, omega_frame)
    qs, flux = van_leer_radial_batch(phys, g, qs, sigma, density_star,
                                     vrad, dt)
    return _azimuthal_half(phys, g, qs, vrad, vaz, energy, omega_frame, dt,
                           shift, partial(fargo_theta, phys, g)) \
        + (flux[-1],)


def _azimuthal_half(phys: Physics, g: Geom, qs, vrad, vaz, energy,
                    omega_frame, dt, shift, theta):
    """What every route does after the radial sweep of the batch ``qs``: the
    residual velocity, the azimuthal sweeps and roll (``theta``, as
    ``fargo_theta`` without its first two arguments), and the velocities.
    Returns (sigma, vrad, vaz, energy)."""
    if shift is None:
        shift = fargo_shift(g, vaz, dt)
    vmean, nshift, vconst = shift
    vres = vaz - vmean
    if not phys.fast_transport:
        vres = vres + vconst
    qs = theta(qs, vres, vconst, nshift, dt, phys.fast_transport)
    if phys.is_adiabatic:
        energy = qs[4]
    sigma = qs[-1]
    vrad, vaz = velocities_from_momenta(g, sigma, qs[0], qs[1], qs[2],
                                        qs[3], vrad, omega_frame)
    return sigma, vrad, vaz, energy



"""Flux-limited-diffusion radiative transport of the midplane temperature
(reference src/fld.cpp): implicit diffusion with the Kley (1989) flux
limiter on a 5-point polar stencil, solved by red-black SOR.

The JAX package runs the SOR in a ``lax.while_loop`` whose condition the
device tests after every double sweep (``check_interval`` = 1). Here the
host drives blocks of double sweeps: each sweep of a block is applied only
while the loop condition holds (``torch.where`` on a 0-d device flag), so
a block that runs past convergence changes nothing, and the host reads the
flag once per block. The iterates, the final temperature and ``n_iter``
are those of the while loop; only the number of host reads changes.

Sharded (``parallel/shard_step.py``), a rank solves on its window: the
halo rows of T are refreshed from the neighbours before each measured
double sweep and once after the loop (``halo_fn``, the reference's
per-iteration exchange, src/fld.cpp:596-656), the red-black colouring
follows the global ring index, and the norm sums the owned active cells
over the ranks (``shard_ctx``; the MPI_Allreduce of :748), so every rank
reads the same flag (fargocpt_tpu/ops/fld.py:177-277).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Physics
from .common import Geom, azim_next, azim_prev, set_rows
from . import opacity as opacity_mod
from .eos import finite_in

# convergence tests the host leaves to the device between two reads, after
# the first block of a solve (as long as the previous solve took)
SOR_BLOCK = 4


def flux_limiter(R):
    """Kley (1989) flux limiter (reference src/fld.cpp:185-195)."""
    lo = 2.0 / (3.0 + torch.sqrt(9.0 + 10.0 * R * R))
    hi = 10.0 / (10.0 * R + 9.0 + torch.sqrt(180.0 * R + 81.0))
    return torch.where(R <= 2.0, lo, hi)


@dataclass(frozen=True)
class FLDConfig:
    tolerance: float = 1e-10
    max_iterations: int = 50000
    omega: float = 1.5
    auto_omega: bool = False          # RadiativeDiffusionAutoOmega
    # none | zeroflux | zerogradient | outflow
    inner_boundary: str = "none"
    outer_boundary: str = "none"
    constant_fluxlimiter: bool = False
    # double sweeps per convergence test (RadiativeDiffusionCheckInterval)
    check_interval: int = 1


class FLDSolver:
    """Radiative diffusion for one configuration. ``iterations`` counts
    the SOR iterations of all solves."""

    def __init__(self, phys: Physics, constants, units, geometry,
                 config: FLDConfig, dtype: torch.dtype, device=None):
        self.phys = phys
        self.constants = constants
        self.units = units
        self.config = config
        self.nrad, self.naz = geometry.nrad, geometry.naz
        ii = np.arange(self.nrad)[:, None]
        jj = np.arange(self.naz)[None, :]
        self.red = torch.tensor((ii + jj) % 2 == 0, device=device)
        self.black = ~self.red
        # active rings of the convergence norm (reference :662-673)
        self.active = torch.tensor(
            np.broadcast_to((ii > 1) & (ii < self.nrad - 2),
                            (self.nrad, self.naz)).copy(), device=device)
        self.n_cells = self.nrad * self.naz
        self.last_n_iter = SOR_BLOCK
        self.iterations = 0             # SOR iterations over all solves

    # ------------------------------------------------------------------
    def diffusion_coefficients(self, g: Geom, rho, T):
        """K on the radial faces (Ka, (NR+1, NAZ), faces 1..NR-1 set) and
        the azimuthal interfaces (Kb, (NR, NAZ), rows 1..NR-2 set)
        (reference src/fld.cpp:458-545)."""
        phys, constants = self.phys, self.constants
        nr = g.nrad

        def coeff(rho_f, T_f, nabla_T):
            kappa = opacity_mod.opacity(phys, self.units, rho_f, T_f)
            lrad = 1.0 / (rho_f * kappa)
            if self.config.constant_fluxlimiter:
                lam = 1.0 / 3.0
            else:
                lam = flux_limiter(4.0 * nabla_T / T_f * lrad)
            return lam * 16.0 * constants.sigma_sb * lrad * T_f ** 3

        T_f = 0.5 * (T[:-1] + T[1:])
        rho_f = 0.5 * (rho[:-1] + rho[1:])
        dT_dr = (T[1:] - T[:-1]) * g.inv_diff_rmed[1:nr]
        T_next = 0.5 * (azim_next(T[:-1]) + azim_next(T[1:]))
        T_prev = 0.5 * (azim_prev(T[:-1]) + azim_prev(T[1:]))
        dT_dphi = g.inv_ra[1:nr] * (T_next - T_prev) / (2.0 * g.dphi)
        ka_mid = coeff(rho_f, T_f, torch.hypot(dT_dr, dT_dphi))
        zrow = torch.zeros_like(ka_mid[:1])
        ka = torch.cat([zrow, ka_mid, zrow], dim=0)

        T_a = 0.5 * (azim_prev(T) + T)
        rho_a = 0.5 * (azim_prev(rho) + rho)
        router = g.ra[2:nr]
        rinner = g.ra[0:nr - 2]
        T_out = 0.5 * (azim_prev(T[2:]) + T[2:])
        T_in = 0.5 * (azim_prev(T[:-2]) + T[:-2])
        dT_dr_a = (T_out - T_in) / (router - rinner)
        dT_dphi_a = g.inv_rb[1:-1] * (T[1:-1] - azim_prev(T[1:-1])) / g.dphi
        kb_mid = coeff(rho_a[1:-1], T_a[1:-1], torch.hypot(dT_dr_a, dT_dphi_a))
        zrow = torch.zeros_like(kb_mid[:1])
        kb = torch.cat([zrow, kb_mid, zrow], dim=0)
        return self._coefficient_boundary(ka, kb)

    def _coefficient_boundary(self, ka, kb):
        """reference src/fld.cpp:357-414."""
        nr = self.nrad
        ib, ob = self.config.inner_boundary, self.config.outer_boundary
        if ib == "zeroflux":
            ka = set_rows(ka, torch.zeros_like(ka), 1, 2)
        elif ib == "zerogradient":
            ka = torch.cat([ka[:1], ka[2:3], ka[2:]], dim=0)
        if ob == "zeroflux":
            ka = set_rows(ka, torch.zeros_like(ka), nr - 1, nr)
        elif ob == "zerogradient":
            ka = torch.cat([ka[:nr - 1], ka[nr - 2:nr - 1], ka[nr:]], dim=0)
        return ka, kb

    def _temperature_boundary(self, T):
        nr = self.nrad
        tmin = torch.full_like(T[:1], self.phys.minimum_temperature)
        if self.config.inner_boundary == "outflow":
            T = torch.cat([tmin, T[1:]], dim=0)
        if self.config.outer_boundary == "outflow":
            T = torch.cat([T[:nr - 1], tmin], dim=0)
        return T

    def matrix_elements(self, g: Geom, rho, ka, kb, dt):
        """The 5-point implicit matrix (reference src/fld.cpp:548-586)."""
        phys, constants = self.phys, self.constants
        nr = g.nrad
        c_v = constants.R / (phys.mu * (phys.adiabatic_index - 1.0))
        common = -dt / (rho * c_v)
        common_ac = common * g.two_diff_ra_sq
        A = common_ac * ka[:-1] * g.ra[:nr] * g.inv_diff_rmed[:nr]
        C = common_ac * ka[1:] * g.ra[1:] * g.inv_diff_rmed[1:]
        common_de = common / (g.rb ** 2 * g.dphi ** 2)
        D = common_de * kb
        E = common_de * azim_next(kb)
        B = -A - C - D - E + 1.0
        return A, B, C, D, E

    def initial_sor_state(self, dtype, device=None):
        """[omega, direction, old_iterations] carried across steps when
        RadiativeDiffusionAutoOmega is on (reference src/fld.cpp:698-700)."""
        return torch.tensor([self.config.omega, 1.0,
                             float(self.config.max_iterations)],
                            dtype=dtype, device=device)

    def adapt_omega(self, sor_state, n_iter):
        """Reverse the walk when the iteration count worsened, step omega
        by 0.01, clamp to [1.0, 1.99] (reference src/fld.cpp:773-792)."""
        omega, direction, old_iter = sor_state[0], sor_state[1], sor_state[2]
        it = torch.as_tensor(n_iter, dtype=sor_state.dtype,
                             device=sor_state.device)
        direction = torch.where(old_iter < it, -direction, direction)
        omega = omega + direction * 0.01
        direction = torch.where(omega >= 2.0, -1.0,
                                torch.where(omega <= 1.0, 1.0, direction))
        omega = torch.clamp(omega, 1.0, 1.99)
        return torch.stack([omega, direction, it])

    def solve(self, T, Told, A, B, C, D, E, omega=None, halo_fn=None,
              shard_ctx=None):
        """Red-black SOR with the reference's convergence test: the change
        of the cell-averaged update norm below the tolerance
        (src/fld.cpp:694-790). Returns (T, n_iter), n_iter a host int.
        ``halo_fn`` and ``shard_ctx`` as the module's docstring says."""
        cfg = self.config
        if omega is None:
            omega = cfg.omega
        tol = cfg.tolerance
        tmin = self.phys.minimum_temperature
        tmax = finite_in(self.phys.maximum_temperature, T.dtype)
        A, B, C, D, E, Told = (x[1:-1] for x in (A, B, C, D, E, Told))
        red, black, active = self.red, self.black, self.active
        n_cells, reduce = self.n_cells, None
        if shard_ctx is not None:
            red, active = shard_ctx["red"], shard_ctx["active"]
            black = ~red
            n_cells, reduce = shard_ctx["n_cells"], shard_ctx["reduce"]
        refresh = halo_fn if halo_fn is not None else (lambda x: x)

        def half_sweep(T, color):
            gs = (A * T[:-2] + C * T[2:]
                  + D * azim_prev(T)[1:-1] + E * azim_next(T)[1:-1] - Told)
            new_mid = torch.clamp((1.0 - omega) * T[1:-1] - omega / B * gs,
                                  tmin, tmax)
            new = torch.cat([T[:1], new_mid, T[-1:]], dim=0)
            return torch.where(color, new, T)

        K = max(int(cfg.check_interval), 1)
        it = torch.zeros((), dtype=torch.int32, device=T.device)
        last_avg = torch.zeros((), dtype=T.dtype, device=T.device)
        change = torch.tensor(torch.finfo(T.dtype).max, dtype=T.dtype,
                              device=T.device)
        block = max(1, self.last_n_iter // K)
        while True:
            for _ in range(block):
                go = (change > tol) & (it < cfg.max_iterations)
                Tn = T
                for _ in range(K - 1):
                    Tn = half_sweep(half_sweep(refresh(Tn), red), black)
                T_old_iter = Tn = refresh(Tn)
                Tn = half_sweep(half_sweep(Tn, red), black)
                diff2 = torch.where(active, (Tn - T_old_iter) ** 2, 0.0)
                ssum = torch.sum(diff2)
                if reduce is not None:
                    ssum = reduce(ssum)
                avg = torch.sqrt(ssum) / n_cells
                T = torch.where(go, Tn, T)
                change = torch.where(go, torch.abs(avg - last_avg), change)
                last_avg = torch.where(go, avg, last_avg)
                it = it + go.to(torch.int32) * K
            if not bool((change > tol) & (it < cfg.max_iterations)):
                break
            block = SOR_BLOCK
        # the ghost rows hold the neighbours' final values
        T = refresh(T)
        n_iter = int(it)
        self.last_n_iter = n_iter
        self.iterations += n_iter
        return T, n_iter

    # ------------------------------------------------------------------
    def radiative_diffusion(self, g: Geom, sigma, energy, scale_height, dt,
                            sor_state=None, halo_fn=None, shard_ctx=None):
        """The FLD substep on the energy (reference src/fld.cpp:965-1019).
        With ``sor_state`` (auto-omega) the relaxation factor is taken from
        and walked in the carried state. Returns (energy, n_iter,
        sor_state)."""
        phys, constants = self.phys, self.constants
        nr = g.nrad
        c_v = constants.R / (phys.mu * (phys.adiabatic_index - 1.0))
        T = self._temperature_boundary(energy / (c_v * sigma))
        rho = sigma / (phys.density_factor * scale_height)
        ka, kb = self.diffusion_coefficients(g, rho, T)
        A, B, C, D, E = self.matrix_elements(g, rho, ka, kb, dt)
        omega = sor_state[0] if sor_state is not None else None
        T_new, n_iter = self.solve(T, T, A, B, C, D, E, omega=omega,
                                   halo_fn=halo_fn, shard_ctx=shard_ctx)
        if sor_state is not None:
            sor_state = self.adapt_omega(sor_state, n_iter)
        energy = set_rows(energy, c_v * T_new * sigma, 1, nr - 1)
        return energy, n_iter, sor_state

"""The radial domain decomposition: a rank's part of the hydro step on
``torch.distributed`` (the JAX package's explicit shard_map path,
fargocpt_tpu/parallel/shard_step.py:91-675, after the reference's MPI slab
decomposition, src/split.cpp:21-397, and halo exchange,
src/commbound.cpp:45-182).

Each rank is one process. Rank k owns the rings ``[k L, (k + 1) L)`` and
steps a window of ``Lx = L + 2 halo`` rings with its own ``HydroStep``,
built from ``Geometry.window`` and the window's reference values, so its
kernels (cfl, sources, viscous_kick, the transport, artvisc_sn) run at Lx
rows. The windows are skewed at the domain edges (``mesh.slab_bounds``):
the first starts at ring 0, the last ends at ring NR - 1, so the unchanged
boundary code, which writes window rows 0, 1, -2 and -1, acts on the true
domain edges on the edge ranks and on halo rows elsewhere, which the next
exchange overwrites.

Between two exchanges every radial stencil spends one ring of the halo's
freshness; the Euler and leapfrog steps spend fewer than the default 10.
Once a step (``advance_to``, and before a lone ``step`` or ``cfl_dt``) one
stacked exchange refreshes the halo rows of sigma, v_rad, v_az, the
energy, Q+ and Q- (and the PVTE warm-start pair). What the ranks must
agree on is reduced over them: the CFL dt (MIN), the disk's force on the
bodies, accretion, the mass bookkeeping, the monitor sums, the
self-gravity kernel's mass average and FLD's norm (SUM, over owned rows).
The bodies are replicated: every rank integrates them from the same
reduced sums, so they stay the same bits on every rank, and so do the dt
and the landing decision each step reads on the host.

Self-gravity convolves the all-gathered global sigma with the whole
grid's solver and keeps the window's rows of the accelerations. FLD
refreshes its temperature's halo rows before each measured SOR double
sweep. The dust is bucketed by slab (``particles/sharded.py``), or, with
``shard_particles=False``, replicated and moved by the whole grid's
stepper against all-gathered fields.

The state a rank carries between calls is its window (``shard_state``);
``gather`` rebuilds the global state on every rank. The JAX package's
GSPMD half of ``parallel/mesh.py`` (an XLA partitioner) has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boundary import RefValues
from ..params import LEAPFROG
from ..state import FieldState, SystemState
from .comm import Communicator
from .mesh import slab_bounds

# the monitor grids of (NR, NAZ) a window carries
_MONITOR_GRIDS = ("massflow", "t_adv", "t_visc", "t_grav", "alpha_grav_mean",
                  "alpha_reynolds_mean")


class ShardedHydroStep:
    """One rank's share of ``stepper``, the whole grid's ``HydroStep``
    (every rank builds the same one, e.g. by ``Simulation``), over the
    ranks of ``comm``:

        ss = ShardedHydroStep(sim.stepper, comm)
        local = ss.shard_state(sim.state)
        local, t, dt, n, *stats = ss.advance_to(local, t, dt, t_target)
        state = ss.gather(local)          # the global state, every rank
    """

    def __init__(self, stepper, comm: Communicator, halo: int = 10,
                 shard_particles: bool = True):
        from ..step import HydroStep
        phys = stepper.phys
        if comm.device != stepper.device:
            raise ValueError(f"the communicator's device {comm.device} is "
                             f"not the stepper's {stepper.device}")
        self.stepper, self.comm = stepper, comm
        self.phys = phys
        self.dtype = stepper.dtype
        self.n, self.rank = comm.size, comm.rank
        geometry = stepper.geometry
        self.NR, self.NAZ = geometry.nrad, geometry.naz
        self.slabs = slab_bounds(self.NR, self.n, halo)
        sl = self.slabs
        self.L, self.Lx, self.halo, self.S = sl.L, sl.Lx, sl.halo, sl.S
        self.win = sl.windows[self.rank]
        k, win, L, Lx, NR = self.rank, self.win, self.L, self.Lx, self.NR
        self.own_off = k * L - win        # first owned row of the window
        self.off_avail = win - k * L + self.S
        self.is_top = k == self.n - 1
        self.shard_particles = bool(shard_particles
                                    and phys.integrate_particles)
        self.particle_C = self.particle_E = None

        ref = stepper.ref_values()
        wref = RefValues(sigma0=ref.sigma0[win:win + Lx],
                         energy0=ref.energy0[win:win + Lx],
                         vrad0=ref.vrad0[win:win + Lx + 1],
                         vaz0=ref.vaz0[win:win + Lx])
        ws = HydroStep(
            phys, stepper.constants, geometry.window(win, Lx), wref,
            stepper.bodies_cfg, stepper.n_hydroframe, dtype=self.dtype,
            device=stepper.device, quad_moment=stepper.quad_moment,
            units=stepper.units, transport_route=stepper.ops.route,
            particle_params=stepper.particle_params
            if phys.integrate_particles else None, shared_from=stepper)
        ws.custom_bc = stepper.custom_bc
        ws.debug_nans = stepper.debug_nans
        self.window = ws

        dev, dt = stepper.device, self.dtype
        rows = win + np.arange(Lx)
        own = (rows >= k * L) & (rows < (k + 1) * L)

        def col(mask):
            return torch.tensor(mask.astype(np.float64)[:, None], dtype=dt,
                                device=dev)
        ws.comm = comm
        ws._own_col = col(own)
        ws._own_int_col = col(own & (rows >= 1) & (rows <= NR - 2))
        ws._own_act_col = col(own & (rows >= 2) & (rows <= NR - 2))
        ws._inner_face = (max(1 - win, 0), 1.0 if win == 0 else 0.0)
        ws._outer_face = (min(max(NR - 1 - win, 0), Lx),
                          1.0 if win + Lx == NR else 0.0)
        ws._halo_refresh = self._refresh_state
        if ws.fld is not None:
            # the red-black colour of the global ring index, and the owned
            # active cells of the norm
            ii = rows[:, None]
            jj = np.arange(self.NAZ)[None, :]
            act = (ii > 1) & (ii < NR - 2) & own[:, None]
            ws._fld_halo_fn = self._refresh_rows
            ws._fld_shard_ctx = {
                "red": torch.tensor((ii + jj) % 2 == 0, device=dev),
                "active": torch.tensor(
                    np.broadcast_to(act, (Lx, self.NAZ)).copy(), device=dev),
                "n_cells": NR * self.NAZ, "reduce": comm.sum}
        if stepper.selfgravity is not None:
            ws._sg_gather = lambda x: comm.gather_rows(self._own(x))
            ws._sg_window = lambda x: x[win:win + Lx]
        if phys.integrate_particles and not self.shard_particles:
            ws._particle_gather = self._gather_fields
            ws._global_stepper = stepper

    # --- rows ---------------------------------------------------------
    def _own(self, x):
        """The owned rows of a window grid (faces: the owned faces
        k L .. (k + 1) L - 1)."""
        return x[self.own_off:self.own_off + self.L]

    def _exchange_blocks(self, stack):
        """(F, L, NAZ) owned rows -> (F, L + 2 S, NAZ): the S rows below
        from the rank below, the owned rows, the S rows above from the
        rank above (zeros past the domain edges)."""
        S = self.S
        below, above = self.comm.exchange(stack[:, -S:], stack[:, :S])
        return torch.cat([below, stack, above], dim=1)

    def _refresh_rows(self, x):
        """The halo rows of one (Lx, NAZ) grid from their owners: FLD's
        per-sweep refresh (one exchange)."""
        avail = self._exchange_blocks(self._own(x)[None])[0]
        return avail[self.off_avail:self.off_avail + self.Lx]

    _XNAMES = ("sigma", "vrad", "vaz", "energy", "qplus", "qminus")

    def _refresh_state(self, state: SystemState) -> SystemState:
        """Every halo row of the exchanged grids from its owner: one
        stacked exchange (fargocpt_tpu/parallel/shard_step.py:332-383;
        the reference sends its fields in one message pair per neighbour,
        src/commbound.cpp:98-182). The PVTE warm-start pair rides along."""
        f = state.fields
        grids = [f.sigma, f.vrad, f.vaz, f.energy, state.qplus, state.qminus]
        if state.pvte_guess is not None:
            grids += list(state.pvte_guess)
        L, Lx, S, off = self.L, self.Lx, self.S, self.off_avail
        avail = self._exchange_blocks(torch.stack([self._own(x)
                                                   for x in grids]))
        iv = self._XNAMES.index("vrad")
        if self.is_top:
            # the global outer face NR exists on the top rank's window only
            avail[iv, L + S] = f.vrad[Lx]
        new = [avail[i, off:off + (Lx + 1 if i == iv else Lx)]
               for i in range(len(grids))]
        kw = {}
        if state.pvte_guess is not None:
            kw["pvte_guess"] = (new[6], new[7])
        return state.replace(
            fields=FieldState(sigma=new[0], vrad=new[1], vaz=new[2],
                              energy=new[3]),
            qplus=new[4], qminus=new[5], **kw)

    def _gather_fields(self, sigma, vrad, vaz, energy):
        """Window fields -> the global fields on every rank, for the
        replicated swarm."""
        g = self.comm.gather_rows
        top = self.comm.broadcast(vrad[self.Lx:self.Lx + 1], self.n - 1)
        return (g(self._own(sigma)), torch.cat([g(self._own(vrad)), top]),
                g(self._own(vaz)), g(self._own(energy)))

    def _map_grids(self, state: SystemState, cells, faces) -> SystemState:
        """``state`` with ``cells`` applied to every grid of cells and
        ``faces`` to v_rad."""
        f, acc = state.fields, state.monitor_acc
        grids = {name: cells(getattr(acc, name)) for name in _MONITOR_GRIDS
                 if getattr(acc, name) is not None}
        return state.replace(
            fields=FieldState(sigma=cells(f.sigma), vrad=faces(f.vrad),
                              vaz=cells(f.vaz), energy=cells(f.energy)),
            qplus=cells(state.qplus), qminus=cells(state.qminus),
            pvte_guess=None if state.pvte_guess is None
            else tuple(cells(x) for x in state.pvte_guess),
            monitor_acc=acc.replace(**grids))

    # --- public -------------------------------------------------------
    def shard_state(self, state: SystemState) -> SystemState:
        """The global state -> this rank's window state (every grid's
        window rows, exact copies, so the halo is fresh); the swarm
        bucketed by slab (``shard_particles``) or kept whole."""
        w, Lx = self.win, self.Lx
        local = self._map_grids(state, lambda x: x[w:w + Lx].clone(),
                                lambda x: x[w:w + Lx + 1].clone())
        if state.particles is not None and self.shard_particles:
            from ..particles import sharded as psh
            self._particle_template = state.particles
            self._n_particles = state.particles.n
            radii = np.asarray(self.stepper.geometry.radii, np.float64)
            sp, C, E, (lo, hi) = psh.shard_particles(
                state.particles, self.n, self.L, radii, self.rank)
            self.particle_C, self.particle_E = C, E
            self.window._particle_shard_ctx = {
                "own_lo": lo, "own_hi": hi, "is_top": self.is_top,
                "is_bot": self.rank == 0, "E": E, "comm": self.comm}
            local = local.replace(particles=sp)
        return local

    def window_accumulators(self, acc):
        """Global monitor accumulators -> a window's: each grid's window
        rows (the scalars are the same on every rank)."""
        w, Lx = self.win, self.Lx
        return acc.replace(**{name: getattr(acc, name)[w:w + Lx].clone()
                              for name in _MONITOR_GRIDS
                              if getattr(acc, name) is not None})

    def gather(self, local: SystemState) -> SystemState:
        """This rank's window state -> the global state, on every rank
        (the buckets back in the swarm's order)."""
        g = self.comm.gather_rows
        Lx = self.Lx

        def faces(x):
            top = self.comm.broadcast(x[Lx:Lx + 1], self.n - 1)
            return torch.cat([g(self._own(x)), top])
        out = self._map_grids(local, lambda x: g(self._own(x)), faces)
        from ..particles import sharded as psh
        if isinstance(local.particles, psh.ShardedParticles):
            out = out.replace(particles=psh.gather_particles(
                local.particles, self.comm, self._n_particles,
                self._particle_template))
        return out

    def step(self, local: SystemState, time, dt) -> SystemState:
        """One hydro step of the whole grid, this rank's share: the halo
        refreshed, then the window stepper's step."""
        return self.window.step(self._refresh_state(local), time, dt)

    def cfl_dt(self, local: SystemState, time=0.0) -> torch.Tensor:
        """The global CFL dt (the least of the ranks'), on every rank."""
        return self.window.cfl_dt(self._refresh_state(local), time)

    def advance_to(self, local: SystemState, time, last_dt, t_target,
                   max_steps: int | None = None, first_step: int = 0):
        """``HydroStep.advance_to`` over the ranks: the halo refreshed
        before each step's CFL; every rank takes the same dt sequence,
        step count and landing time."""
        return self.window.advance_to(local, time, last_dt, t_target,
                                      max_steps, first_step)

    def overflow(self, local: SystemState) -> int:
        """The particles the buckets dropped so far, summed over the ranks
        (0 without buckets)."""
        from ..particles import sharded as psh
        if not isinstance(local.particles, psh.ShardedParticles):
            return 0
        return int(self.comm.sum(local.particles.overflow.reshape(1)
                                 .to(torch.float64))[0])

    def comm_model(self, fld_iters: int = 50) -> dict[str, int]:
        """Bytes an interior rank sends a hydro step, by kind (the JAX
        package's ``comm_model``, fargocpt_tpu/parallel/shard_step.py:
        583-650): the stacked halo exchange (6 grids, 8 with PVTE; S rows
        each way), the migration buffers of the buckets or the four
        gathered grids of the replicated swarm per integration, the
        self-gravity sigma gather per kick (all_gather: n - 1 slabs), and
        FLD's single-grid exchange per SOR double sweep. An edge rank
        sends half the exchanges. ``faces_and_scalars`` is the JAX model's
        estimate of the reductions, not a count."""
        item = torch.empty((), dtype=self.dtype).element_size()
        n, L, S = self.n, self.L, self.S
        row = self.NAZ * item
        phys = self.phys
        model = {}
        n_grids = len(self._XNAMES) + (2 if phys.variable_gamma
                                       and self.stepper.pvte.fast else 0)
        model["halo_exchange"] = n_grids * S * row * 2
        model["faces_and_scalars"] = row + 40 * item
        k = 2 if phys.hydro_integrator == LEAPFROG else 1
        if phys.integrate_particles:
            if self.shard_particles:
                E = self.particle_E or 64
                model["particles_migration"] = k * 2 * E * (8 * item + 3 * 4)
            else:
                # three cell grids and v_rad with its top face (the
                # broadcast's row); the JAX model counts four slabs
                model["particles_allgather"] = 4 * k * (n - 1) * L * row
        if self.stepper.selfgravity is not None:
            kicks = k
            if phys.write_alpha_grav_mean:
                kicks += 1
            if phys.integrate_particles and \
                    self.stepper.particle_params.disk_gravity:
                kicks += k
            model["selfgravity_allgather"] = kicks * (n - 1) * L * row
        if self.stepper.fld is not None:
            model["fld_exchange"] = fld_iters * S * row * 2
        model["total"] = sum(model.values())
        return model

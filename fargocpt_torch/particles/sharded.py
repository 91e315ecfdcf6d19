"""The dust swarm bucketed by radial slab, with migration to the
neighbours (the JAX package's fargocpt_tpu/particles/sharded.py, after the
reference's per-rank particle domains, src/particles/particles.cpp:259-420,
and its two-phase ``move``, :2016-2160).

A rank keeps the particles whose radius lies in its slab in a bucket of C
slots, moves them against its window's gas with the window stepper's own
integrator, and after each integration sends the ones that left the slab
to the neighbour they entered, in fixed buffers of E slots each way (one
exchange of an (8, E) float stack and one of a (3, E) int32 stack: pid,
alive, used). C is the largest initial census of a slab times a margin
(1.5), at least 16; E is max(64, C // 8). A particle that finds no buffer
slot or no free slot is dropped and counted in ``overflow``, as the JAX
package does; the reference reallocates instead.

Slots: ``valid`` holds a particle (alive, or frozen after escaping the
domain; the escaped never migrate), ``pid`` its index in the swarm, which
``gather_particles`` restores. Empty slots start at the slab's centre and
are masked out of every update by ``alive``.

The diffusion draws come from each rank's own generator (seeded from the
swarm's seed and the rank), so a bucketed diffusing swarm follows its own
random path, as the JAX package's per-shard keys do.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .dust import ParticleState

# the payload of a migrating particle, in buffer order
_FIELDS = ("r", "phi", "r_dot", "phi_dot", "size", "stokes",
           "timestep", "facold")


@dataclass(frozen=True)
class ShardedParticles:
    """A rank's bucket of C slots; ``overflow`` (0-d int32) counts the
    particles this rank dropped."""
    r: torch.Tensor
    phi: torch.Tensor
    r_dot: torch.Tensor
    phi_dot: torch.Tensor
    size: torch.Tensor
    stokes: torch.Tensor
    timestep: torch.Tensor
    facold: torch.Tensor
    alive: torch.Tensor
    valid: torch.Tensor
    pid: torch.Tensor
    overflow: torch.Tensor
    rng: torch.Generator | None = field(default=None, compare=False)

    def replace(self, **kw) -> "ShardedParticles":
        return replace(self, **kw)


def slot_capacity(counts) -> int:
    """Slots a bucket: the largest initial census times 1.5, at least
    16."""
    return max(int(np.ceil(max(int(np.max(counts)), 1) * 1.5)), 16)


def exchange_capacity(C: int) -> int:
    """Buffer slots each way: max(64, C // 8)."""
    return max(64, C // 8)


def shard_particles(ps: ParticleState, n: int, L: int, radii, rank: int):
    """This rank's bucket of the whole swarm ``ps`` (every rank holds it).
    Returns (ShardedParticles, C, E, (lo, hi) of this rank's slab)."""
    radii = np.asarray(radii, np.float64)
    r = ps.r.detach().cpu().numpy()
    edges = np.asarray([radii[k * L] for k in range(n + 1)], np.float64)
    # each slab's radius bounds, the domain's edges opened so that frozen
    # escapers stay with the edge ranks
    lo, hi = edges[:-1].copy(), edges[1:].copy()
    lo[0], hi[-1] = -np.inf, np.inf
    shard_of = np.clip(np.searchsorted(edges, r, side="right") - 1, 0, n - 1)
    counts = np.bincount(shard_of, minlength=n)
    C = slot_capacity(counts)
    E = exchange_capacity(C)
    if counts.max() > C:
        raise ValueError(f"particle slot capacity {C} below initial census "
                         f"{counts.max()}")
    mine = np.nonzero(shard_of == rank)[0]
    m = mine.size
    dev, dt = ps.r.device, ps.r.dtype
    centre = 0.5 * (np.clip(lo[rank], radii[0], radii[-1])
                    + np.clip(hi[rank], radii[0], radii[-1]))
    idx = torch.tensor(mine, dtype=torch.long, device=dev)

    def slots(name, fill):
        out = torch.full((C,), fill, dtype=dt, device=dev)
        out[:m] = getattr(ps, name)[idx]
        return out
    fills = {"r": centre, "size": 1.0}
    kw = {name: slots(name, fills.get(name, 0.0)) for name in _FIELDS}
    alive = torch.zeros(C, dtype=torch.bool, device=dev)
    alive[:m] = ps.alive[idx]
    valid = torch.zeros(C, dtype=torch.bool, device=dev)
    valid[:m] = True
    pid = torch.full((C,), -1, dtype=torch.int32, device=dev)
    pid[:m] = idx.to(torch.int32)
    rng = None
    if ps.rng is not None:
        rng = torch.Generator(device=dev).manual_seed(
            ps.rng.initial_seed() + 1_000_003 * rank)
    return (ShardedParticles(
        **kw, alive=alive, valid=valid, pid=pid,
        overflow=torch.zeros((), dtype=torch.int32, device=dev), rng=rng),
        C, E, (float(lo[rank]), float(hi[rank])))


def gather_particles(sp: ShardedParticles, comm, n_total: int,
                     template: ParticleState) -> ParticleState:
    """Every rank's bucket -> the whole swarm in pid order, on every rank.
    A particle dropped by an overflow is missing: it comes back dead, at
    radius 0."""
    g = comm.gather_rows
    pid = g(sp.pid)
    sel = g(sp.valid) & (pid >= 0)
    idx = pid[sel].long()

    def scatter(src, fill, dtype):
        out = torch.full((n_total,), fill, dtype=dtype, device=src.device)
        out[idx] = g(src)[sel]
        return out
    kw = {name: scatter(getattr(sp, name), 0.0, sp.r.dtype)
          for name in _FIELDS}
    return template.replace(alive=scatter(sp.alive, False, torch.bool), **kw)


def _pack(mask, arrs, E):
    """The masked slots of each array, first come first served in slot
    order, into E-slot buffers; returns (buffers, used, dropped)."""
    sel = torch.nonzero(mask).flatten()
    take = sel[:E]
    m = take.numel()
    bufs = []
    for a in arrs:
        b = torch.zeros(E, dtype=a.dtype, device=a.device)
        b[:m] = a[take]
        bufs.append(b)
    used = torch.zeros(E, dtype=torch.bool, device=mask.device)
    used[:m] = True
    return bufs, used, sel.numel() - m


def _merge(free, arrs, bufs, used):
    """The used buffer rows into the free slots, the i-th row into the
    i-th free slot; returns (arrays, taken, dropped)."""
    slots = torch.nonzero(free).flatten()
    rows = torch.nonzero(used).flatten()
    m = min(slots.numel(), rows.numel())
    out = []
    for a, b in zip(arrs, bufs):
        a = a.clone()
        a[slots[:m]] = b[rows[:m]]
        out.append(a)
    taken = torch.zeros_like(free)
    taken[slots[:m]] = True
    return out, taken, rows.numel() - m


def migrate(sp: dict, own_lo: float, own_hi: float, is_top: bool,
            is_bot: bool, E: int, comm) -> dict:
    """One migration sweep of a rank's slots (``sp``: name -> (C,)
    tensor, with ``alive``, ``valid``, ``pid`` and the 0-d ``overflow``):
    the live particles outside [own_lo, own_hi) go to the neighbour in one
    exchange each way and land in its free slots (fargocpt_tpu/particles/
    sharded.py:230-314). The edge ranks send nothing past the domain."""
    r, valid, alive = sp["r"], sp["valid"], sp["alive"]
    movable = valid & alive
    send_up = movable & (r >= own_hi) if not is_top else \
        torch.zeros_like(movable)
    send_dn = movable & (r < own_lo) if not is_bot else \
        torch.zeros_like(movable)
    payload = [sp[name] for name in _FIELDS]
    ichan = [sp["pid"], alive.to(torch.int32)]
    up_f, up_used, up_drop = _pack(send_up, payload, E)
    dn_f, dn_used, dn_drop = _pack(send_dn, payload, E)
    up_i, _, _ = _pack(send_up, ichan, E)
    dn_i, _, _ = _pack(send_dn, ichan, E)
    below_f, above_f = comm.exchange(torch.stack(up_f), torch.stack(dn_f))
    below_i, above_i = comm.exchange(
        torch.stack(up_i + [up_used.to(torch.int32)]),
        torch.stack(dn_i + [dn_used.to(torch.int32)]))

    sent = send_up | send_dn
    valid = valid & ~sent
    arrs = [torch.where(sent, torch.zeros_like(a), a) for a in payload]
    pid = torch.where(valid, sp["pid"], torch.full_like(sp["pid"], -1))
    alive_i = (alive & valid).to(torch.int32)
    free = ~valid
    nf = len(payload)
    out1, taken1, drop1 = _merge(free, arrs + [pid, alive_i],
                                 list(below_f) + [below_i[0], below_i[1]],
                                 below_i[2] > 0)
    free = free & ~taken1
    out2, taken2, drop2 = _merge(free, out1, list(above_f)
                                 + [above_i[0], above_i[1]], above_i[2] > 0)
    valid = valid | taken1 | taken2
    out = dict(sp)
    out.update(zip(_FIELDS, out2[:nf]))
    out["alive"] = (out2[nf + 1] > 0) & valid
    out["pid"] = torch.where(valid, out2[nf], torch.full_like(out2[nf], -1))
    out["valid"] = valid
    out["overflow"] = sp["overflow"] + (up_drop + dn_drop + drop1 + drop2)
    return out


def integrate_bucket(ws, sigma, vrad, vaz, energy, nb, sp: ShardedParticles,
                     omega_frame, dt, time) -> ShardedParticles:
    """A rank's bucket moved against its window's gas by the window
    stepper ``ws`` (empty slots frozen), then one migration sweep
    (fargocpt_tpu/step.py:1306-1335)."""
    ctx = ws._particle_shard_ctx
    local = ParticleState(
        r=sp.r, phi=sp.phi, r_dot=sp.r_dot, phi_dot=sp.phi_dot,
        size=sp.size, stokes=sp.stokes, alive=sp.alive & sp.valid,
        timestep=sp.timestep, facold=sp.facold, rng=sp.rng)
    local = ws._particle_core(sigma, vrad, vaz, energy, nb, local,
                              omega_frame, dt, time)
    slots = {name: getattr(local, name) for name in _FIELDS}
    slots.update(alive=local.alive, valid=sp.valid, pid=sp.pid,
                 overflow=sp.overflow)
    out = migrate(slots, ctx["own_lo"], ctx["own_hi"], ctx["is_top"],
                  ctx["is_bot"], ctx["E"], ctx["comm"])
    return sp.replace(**{name: out[name] for name in _FIELDS},
                      alive=out["alive"], valid=out["valid"], pid=out["pid"],
                      overflow=out["overflow"])

"""A sharded run with output: ``Simulation.run`` over the ranks of a
communicator, the counterpart of the JAX package's run on a radial mesh
(the GSPMD run behind tests/test_sharding.py). It is a library entry, not
a command-line option, as in the JAX package.

Every rank builds the same ``Simulation`` and calls ``run`` with its
communicator. ``run`` puts a sharded advancer in ``sim.advancer``, so
``Simulation.run`` keeps its own loop, dt priming, statistics and hooks:
each monitor interval is one ``ShardedHydroStep.advance_to``, and at its
end the state is gathered onto every rank (``sim.state``). Rank 0's
``OutputWriter`` writes the monitor files of the serial layout. At a
snapshot, with DistributedOutput every rank writes the rows it owns and
rank 0 the rest (``output.write_sharded_snapshot``, the snapshot hook);
without it rank 0 writes the serial layout of the gathered state.
``monitor_stats["particle_overflow"]`` is the particles the slab buckets
dropped by then, summed over the ranks.
"""

from __future__ import annotations

import dataclasses

from .. import output as out_mod
from .shard_step import ShardedHydroStep


class ShardedAdvancer:
    """``cfl_dt`` and ``advance_to`` of ``HydroStep`` on the global state,
    done by ``ss`` on this rank's window state ``local``, which it keeps.
    The global state it is handed is the one it returned last, after the
    output hooks: it takes from it only the monitor accumulators, rank
    0's, which its writer may have cleared."""

    def __init__(self, ss: ShardedHydroStep, state):
        self.ss = ss
        self.local = ss.shard_state(state)

    def _adopt_accumulators(self, state):
        acc, comm = state.monitor_acc, self.ss.comm
        acc = acc.replace(**{f.name: comm.broadcast(getattr(acc, f.name), 0)
                             for f in dataclasses.fields(acc)
                             if getattr(acc, f.name) is not None})
        self.local = self.local.replace(
            monitor_acc=self.ss.window_accumulators(acc))

    def cfl_dt(self, state, time):
        return self.ss.cfl_dt(self.local, time)

    def advance_to(self, state, time, last_dt, t_target, max_steps=None,
                   first_step=0):
        self._adopt_accumulators(state)
        self.local, *rest = self.ss.advance_to(
            self.local, time, last_dt, t_target, max_steps, first_step)
        return (self.ss.gather(self.local), *rest)


def run(sim, comm, outdir=None, max_steps: int | None = None):
    """Run ``sim`` to its last output time (or ``max_steps`` hydro steps)
    over the ranks of ``comm``, writing to ``outdir`` when given. Returns
    the ``ShardedHydroStep`` and this rank's final window state;
    ``sim.state`` holds the gathered global state."""
    ss = ShardedHydroStep(sim.stepper, comm)
    advancer = ShardedAdvancer(ss, sim.state)
    sim.advancer = advancer
    writer = None
    if outdir is not None:
        out_mod.check_supported(sim.phys, comm.size)
        if comm.rank == 0:
            writer = out_mod.OutputWriter(sim, outdir)
        comm.barrier()
        if sim.phys.distributed_output and comm.size > 1:
            if writer is not None:
                sim.snapshot_hooks.remove(writer._on_snapshot)
            sim.snapshot_hooks.append(
                lambda s: out_mod.write_sharded_snapshot(
                    s, ss, advancer.local, outdir, writer))

    def overflow(s):
        if s.monitor_stats:
            s.monitor_stats["particle_overflow"] = ss.overflow(advancer.local)
    sim.monitor_hooks.insert(0, overflow)
    try:
        sim.run(max_steps)
    finally:
        sim.advancer = None
        if writer is not None:
            writer.close()
    return ss, advancer.local

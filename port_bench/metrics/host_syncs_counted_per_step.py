"""host_syncs_counted_per_step: the host's waits for the card that the
program counts at their sites (``fargocpt_torch.telemetry``'s ``sync.*``
counters: the landing test, the scalar uploads and the dt statistics of
the host loop, FLD's reads, the writers' synchronises and reads), summed
over the traced window's calls, per hydro step. None where the program
keeps no such counters."""

from port_bench import program

SPANS = ()


def read(tr):
    return program.counter_per_step(tr, "sync")

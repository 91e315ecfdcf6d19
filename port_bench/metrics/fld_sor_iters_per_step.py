"""fld_sor_iters_per_step: the SOR iterations of FLD's solves in the
traced window (the program's ``fld.sor_iterations`` counter), per hydro
step. None where the program keeps no such counter."""

from port_bench import program

SPANS = ()


def read(tr):
    return program.counter_per_step(tr, "fld.sor_iterations")

"""The frozen yardstick of the kernels' roofline shares: for each op that
the port runs as a hand-written CUDA kernel, the bytes its algorithm must
read and write once and the operations it must make, from NR, NAZ and the
dtype alone, and the card's peaks.

The bytes are counted from what the op's definition reads and writes,
not from the tensors a wrapper happens to receive, so a change to a
wrapper or a kernel (a fusion, a split, a rewrite) is read against the
same work. A plane is one (NR, NAZ) grid, a v-plane one (NR + 1, NAZ) grid
(v_rad and the mass flux live on the interfaces), a column table the
(NR + 1, 24) geometry the kernels read.

The operations per cell were counted once on the benchmark's plain
reference at 32 x 64 with ``count_flops_per_cell`` (each arithmetic op,
math function, min/max and compare counts once per element of its largest
operand, data movement nothing) and are frozen here.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 rate; float32 and float64 outside the
# tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 34e12}
N_COLS = 24

# op -> (planes read, v-planes read, planes written, v-planes written)
TRAFFIC = {
    # sigma, energy, v_az, Q+, Q- and v_rad in; dt out
    "cfl": (5, 1, 0, 0),
    # sigma, energy, v_az, v_rad in; v_rad, v_az out
    "sources": (3, 1, 1, 1),
    # sigma, energy, v_az, v_rad in; v_rad, v_az, energy, Q+, Q- out
    "viscous_kick": (3, 1, 4, 1),
    # sigma, energy, v_az, v_rad in; the four fields and the mass flux out
    "transport": (3, 1, 3, 2),
    # sigma, energy, v_az, v_rad in; v_rad, v_az, energy out
    "artvisc_sn": (3, 1, 2, 1),
}

# operations per cell of each op's plain version (count_flops_per_cell,
# the flagship at 32 x 64; artvisc_sn on the PVTE gas setup)
FLOPS_PER_CELL = {
    "cfl": 47.15,
    "sources": 63.46,
    "viscous_kick": 184.74,
    "transport": 442.56,
    "artvisc_sn": 29.78,
}


def op_bytes(op: str, nr: int, naz: int, itemsize: int) -> int:
    """Bytes ``op`` must read and write once on an NR x NAZ grid."""
    p_in, v_in, p_out, v_out = TRAFFIC[op]
    plane, vplane = nr * naz * itemsize, (nr + 1) * naz * itemsize
    cols = (nr + 1) * N_COLS * itemsize
    return (p_in + p_out) * plane + (v_in + v_out) * vplane + cols


def op_flops(op: str, nr: int, naz: int) -> float:
    return FLOPS_PER_CELL[op] * nr * naz


def least_s(op: str, nr: int, naz: int, itemsize: int) -> float:
    """Least time of one call on the card: the bytes at the memory rate
    or the operations at the dtype's rate, whichever is longer."""
    return max(op_bytes(op, nr, naz, itemsize) / HBM_BYTES_PER_S,
               op_flops(op, nr, naz) / OPS_PER_S[itemsize])


def count_flops_per_cell(nr: int = 32, naz: int = 64) -> dict[str, float]:
    """Count each op's operations per cell on the plain reference (CPU,
    float64) at ``nr`` x ``naz``: how ``FLOPS_PER_CELL`` was made."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from .reference.fargo_plain.config import Config
    from .reference.fargo_plain.ops import kernels as K, transport as tr
    from .reference.fargo_plain.sim import Simulation

    counted = frozenset((
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt",
        "reciprocal", "exp", "log", "pow", "floor", "sign", "maximum",
        "minimum", "clamp", "clamp_min", "clamp_max", "max", "min", "amax",
        "amin", "sum", "mean", "gt", "lt", "ge", "le", "eq", "ne"))

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in counted:
                ts = [t for t in (*args, *(kwargs or {}).values(),
                                  *(out if isinstance(out, tuple)
                                    else (out,)))
                      if torch.is_tensor(t)]
                if any(t.is_floating_point() for t in ts):
                    self.flops += max(t.numel() for t in ts)
            return out

    from .harness import load_config
    counts = {}
    for cfg_name, ops in (("adiabatic_disk", ("cfl", "sources",
                                              "viscous_kick", "transport")),
                          ("pvte_fld_sg_dust", ("artvisc_sn",))):
        setup = dict(load_config(cfg_name)["setup"], Nrad=str(nr),
                     Naz=str(naz), NumberOfParticles="0",
                     IntegrateParticles="no")
        sim = Simulation(Config.from_dict(setup), device="cpu",
                         dtype="float64")
        st, f, q = sim.stepper, sim.fields, sim.state
        ctx, dt = st.ops, torch.tensor(1e-3, dtype=torch.float64)
        omega = q.omega_frame
        bodies = st.bodies_on_grid(q.nbody, 0.0)
        zero = torch.zeros((), dtype=torch.float64)
        s, vr, va, e = f.sigma, f.vrad, f.vaz, f.energy
        calls = {
            "cfl": lambda: K.cfl(ctx, s, vr, va, e, q.qplus, q.qminus),
            "sources": lambda: K.sources(ctx, s, vr, va, e, bodies,
                                         (zero, zero), omega, dt),
            "viscous_kick": lambda: K.viscous_kick(ctx, s, vr, va, e, dt,
                                                   0.0),
            "transport": lambda: K.transport(
                ctx, s, vr, va, e, omega, dt,
                tr.fargo_shift(ctx.g, va, dt), route="whole"),
            "artvisc_sn": lambda: K.artvisc_sn(ctx, s, vr, va, e, dt),
        }
        for op in ops:
            with Counter() as c:
                calls[op]()
            counts[op] = float(c.flops) / (nr * naz)
    return counts

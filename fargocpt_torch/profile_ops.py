"""The flagship's four fused ops, ``advect_shift``, the two azimuthal
sweeps and the two radial sweeps alone on one CUDA GPU: where their time
goes, launch by launch.

    python -m fargocpt_torch.profile_ops [--nrad 1024] [--naz 3072]
        [--ops transport,viscous_kick,...] [--steps] [--routes whole,...]
        [--sass] [--save FILE] [--against FILE] [--define NAME=n,...]
        [--variants "NAME=n,...;NAME=n;..."]

On the flagship's state with seeded noise (``perturbed``), float32, for
each op of ``--ops`` (default: all of ``OP_NAMES``):
  * ``transport`` (whole route), ``viscous_kick``, ``sources``, ``cfl``,
    ``theta_sweep`` and ``fargo_theta`` on the batches the staged and the
    split route give them (the radially swept momenta; fargo_theta with
    both sweeps and the roll), and ``radial_momenta_sweep`` and
    ``radial_sweep`` on what the split and the staged route give them (the
    fields and the sigma flux; the stacked momenta, sigma and the flux):
    the median over 25 calls of the time between CUDA events around the
    call (the wrapper included), the device time of each of its launches
    (``torch.profiler``, median over 10 calls), the bytes each launch must
    move (its distinct inputs read once and outputs written once,
    ``LAUNCH_PLANES``) and the memory rate that makes, the wrapper's share
    (events minus device time), the host time of one call, and the device
    launches a call makes besides the op's own kernels (PyTorch kernels,
    copies and fills that its wrapper adds);
  * ``advect_shift`` on the batch the staged route gives it, likewise, and
    beside it the one PyTorch call that computes the same, ``torch.gather``
    with a prebuilt index;
  * a SHA-256 of each op's outputs; ``--save FILE`` writes the outputs and
    ``--against FILE`` holds them against a saved set value for value (the
    largest difference and the number of values that differ: -0.0 equals
    0.0), so two checkouts can be held against each other; with cfl,
    theta_sweep or fargo_theta among the ops, the outputs include those of
    the op at the shapes of ``EDGE_SHAPES``, with a radial sweep those at
    ``RADIAL_SHAPES``, which cross the edges of its blocks and strips, in
    both dtypes on seeded random inputs (``edge_outputs``);
  * with ``--steps``: the flagship step on each route of ``--routes``
    (default: the whole route) and the PDS70 gas step at the same size
    through ``profile_step.profile_grid``: wall and device time a step,
    device time and launches a step of each op;
  * with ``--sass``: ``nvcc -Xptxas -v`` of each op's source (registers,
    spills, shared memory per kernel) and, from ``cuobjdump -sass``, each
    kernel's count of SASS operations and, among them, of reciprocals
    (MUFU.RCP, one per float32 division, and MUFU.RCP64H, one per float64
    division), square roots (MUFU.SQRT, MUFU.RSQ and their 64H forms) and
    exponentials (MUFU.EX2);
  * with ``--variants``: the ops of ``--ops`` once more for each variant of
    the CUDA sources, on the same inputs: a variant
    rewrites ``constexpr int NAME = <number>;`` in a copy of ``csrc/`` to
    the given numbers and is built beside the checkout's own kernels; the
    checkout's are measured before the first and after the last, each in
    a process of its own (``--define NAME=n,...`` is one such variant).
    Per variant: device and event time of each op and how many values of
    its outputs differ from the checkout's.

The module uses only what every checkout of the port has had (the ops'
entry points, ``Simulation``, ``profile_step``), so a copy of it placed in
an older checkout's ``fargocpt_torch/`` measures that checkout: two
checkouts are compared by running them in turns on one card. The last line
is all of it as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at 700 W

OP_NAMES = ("transport", "viscous_kick", "sources", "cfl", "advect_shift",
            "theta_sweep", "fargo_theta", "radial_momenta_sweep",
            "radial_sweep")

# device kernel name fragment -> (NR, NAZ) planes it must move for a batch
# of K quantities: distinct inputs once, outputs once. The first three are
# transport.cu's launches; tr_theta_kernel and tr_final_kernel were those of
# its first version (one thread per cell and stage), and vk_artvisc_kernel,
# vk_stress_kernel and vk_update_kernel those of the viscous kick's first
# version, which handed its intermediates through device memory.
LAUNCH_PLANES = {
    "tr_radial_kernel": lambda k: 4 + k + 1,     # fields -> batch, flux
    "tr_ring_kernel": lambda k: k + 1 + 5,       # batch, vaz -> 5 planes
    "tr_vrad_kernel": lambda k: 3 + 1,           # rp, rm, sigma -> vrad
    "tr_theta_kernel": lambda k: k + 1 + k,      # batch, vaz -> batch
    "tr_final_kernel": lambda k: k + 4,          # batch -> 4 fields
    "advect_shift": lambda k: 2 * k,             # batch -> batch
    "vk_tile_kernel": lambda k: 4 + 5,           # fields -> 5 planes
    "vk_artvisc_kernel": lambda k: 4 + 3,        # fields -> e1, vr1, va1
    "vk_stress_kernel": lambda k: 4 + 4,         # sigma, 3 -> 4 planes
    "vk_update_kernel": lambda k: 8 + 5,         # sigma, 7 -> 5 planes
    "sources_kernel": lambda k: 4 + 2,           # fields -> vrad, vaz
    "cfl_ring_kernel": lambda k: 6,              # fields, Q+, Q- -> dt
    "vmean_kernel": lambda k: 1,                 # vaz -> (NR,)
    "cfl_cells_kernel": lambda k: 6,             # fields, Q+, Q- -> partials
    "cfl_final_kernel": lambda k: 0,             # partials -> dt
    # theta_sweep and fargo_theta: theta_ring_kernel, one launch a call;
    # theta_sweep_kernel was the earlier one thread a cell and sweep
    "theta_ring_kernel": lambda k: 2 * k + 1,    # batch, v -> batch
    "theta_sweep_kernel": lambda k: 2 * k + 1,
    # radial_momenta_sweep and radial_sweep: radial_march_kernel with the
    # MarchFields and the MarchBatch source, one launch a call; rms_kernel
    # and radial_sweep_kernel were the earlier one thread a value or cell
    "MarchFields": lambda k: 5 + k,              # fields, base -> batch
    "MarchBatch": lambda k: 2 * k + 3,           # batch, sigma, vrad, base
    "rms_kernel": lambda k: 5 + k,               #   -> batch
    "radial_sweep_kernel": lambda k: 2 * k + 3,
}
# each op's device kernel name fragments
OP_FRAGMENTS = {"transport": ("tr_",), "viscous_kick": ("vk_",),
                "sources": ("sources_kernel",),
                "cfl": ("vmean_kernel", "cfl_"),
                "advect_shift": ("advect_shift",),
                "theta_sweep": ("theta_",), "fargo_theta": ("theta_",),
                "radial_momenta_sweep": ("MarchFields", "rms_kernel"),
                "radial_sweep": ("MarchBatch", "radial_sweep_kernel")}

# (NR, NAZ) of the tile-edge outputs of cfl, theta_sweep and fargo_theta:
# rings of 1 and 7 cells, NAZ under and over a tile of either dtype and
# sweep count (508 and 504 cells in float32, 252 and 248 in float64),
# several tiles with a ragged last one; NR >= 4, which every checkout of
# the port takes
EDGE_SHAPES = ((4, 1), (4, 7), (20, 7), (37, 1030), (4, 247), (4, 253),
               (4, 503), (4, 509))
# (NR, NAZ) of the strip-edge outputs of the radial sweeps (a thread
# marches up a strip of 16 rows, a block holds 128 columns): NR from the
# smallest grid the ops take through one under, on and one over a strip to
# two strips and a row, NAZ 1 and 7 and one under, on and one over a block,
# and several blocks with a ragged last one
RADIAL_SHAPES = tuple((nr, naz) for nr in (3, 4, 15, 16, 17, 33)
                      for naz in (1, 7, 127, 128, 129)) + ((37, 1030),)


def perturbed(sim) -> dict:
    """The simulation's fields with seeded noise (the unperturbed disk is
    axisymmetric, which would leave the azimuthal stencils untested)."""
    st = sim.state
    gen = torch.Generator(device=st.fields.sigma.device).manual_seed(7)

    def noisy(t, rel=0.0, add=0.0):
        u = 2.0 * torch.rand(t.shape, generator=gen, device=t.device,
                             dtype=t.dtype) - 1.0
        return t * (1.0 + rel * u) + add * u

    return {"sigma": noisy(st.fields.sigma, rel=1e-2),
            "vrad": noisy(st.fields.vrad, add=1e-4),
            "vaz": noisy(st.fields.vaz, add=1e-3),
            "energy": noisy(st.fields.energy, rel=1e-2)}


def event_ms(fn, reps=25) -> float:
    """Median over ``reps`` calls of the time between CUDA events around
    ``fn``."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps=25) -> float:
    """Median host time of one call of ``fn`` (enqueue only: the device is
    idle at the start and is not waited for)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def launch_times(fn, fragments, calls=10) -> tuple[list[dict], float]:
    """The device kernels whose name holds one of ``fragments``, in launch
    order within one call of ``fn``: name and median device time in ms over
    ``calls`` profiled calls. Also the other device events (PyTorch's
    kernels, copies and fills) a call makes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):       # the profiler now and then drops device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # the spans' device-side annotations (``fc:``) are not work
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("fc:")]
        found = sorted(
            ((e.time_range.start, e.name, e.time_range.elapsed_us())
             for e in device if any(f in e.name for f in fragments)),
            key=lambda x: x[0])
        if found and len(found) % calls == 0:
            break
    else:
        raise RuntimeError(f"the profiler saw {len(found)} launches of "
                           f"{fragments} in {calls} calls, three times")
    per_call = len(found) // calls
    out = []
    for pos in range(per_call):
        rows = found[pos::per_call]
        names = {name for _, name, _ in rows}
        if len(names) != 1:
            raise RuntimeError(f"launch {pos} has several names: {names}")
        out.append({"kernel": rows[0][1],
                    "device_ms": float(np.median([us for *_, us in rows]))
                    / 1e3})
    return out, (len(device) - len(found)) / calls


def short_name(kernel: str) -> str:
    """The kernel's name, with the radial march's source policy."""
    m = re.search(r"(\w+_kernel)", kernel)
    if not m:
        return kernel[:40]
    src = re.search(r"(March\w+)<", kernel)
    return m.group(1) + (f"<{src.group(1)}>" if src else "")


def with_bytes(launches, k, plane_bytes) -> list[dict]:
    """Adds to each launch the bytes it must move, the least time that
    takes at the memory rate and the rate achieved."""
    for row in launches:
        planes = next((fn(k) for frag, fn in LAUNCH_PLANES.items()
                       if frag in row["kernel"]), None)
        row["kernel"] = short_name(row["kernel"])
        if planes:
            row["bytes"] = planes * plane_bytes
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            row["tb_per_s"] = row["bytes"] / (row["device_ms"] * 1e-3) / 1e12
            row["share_of_memory_rate"] = row["tb_per_s"] * 1e12 \
                / HBM_BYTES_PER_S
    return launches


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def profile_op(fn, fragments, k, plane_bytes) -> dict:
    launches, others = launch_times(fn, fragments)
    launches = with_bytes(launches, k, plane_bytes)
    events = event_ms(fn)
    device = sum(row["device_ms"] for row in launches)
    return {"event_ms": events, "device_ms": device,
            "wrapper_ms": events - device, "host_ms": host_ms(fn),
            "pytorch_launches": others, "launches": launches}


def differences(outputs: dict, saved: dict) -> dict:
    """Per output: how many values differ from the saved set's and the
    largest absolute difference (a NaN on both sides does not differ)."""
    out = {}
    for name, t in outputs.items():
        ref = saved[name].to(t.device)
        both_nan = torch.isnan(t) & torch.isnan(ref)
        diff = (t.double() - ref.double()).abs().masked_fill(both_nan, 0.0)
        out[name] = {"values_that_differ": int(((t != ref) & ~both_nan).sum()),
                     "max_abs_diff": float(diff.max())}
    return out


def radial_inputs(nr: int, naz: int, k_quant: int, dtype, device) -> dict:
    """Seeded random inputs of the radial sweeps: the fields (vrad of both
    signs), a batch of K planes, dt and the frame rate."""
    rng = np.random.default_rng((nr, naz, k_quant))

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)
    return {"sigma": t(rng.random((nr, naz)) + 0.5),
            "vrad": t((rng.random((nr + 1, naz)) - 0.5) * 0.05),
            "vaz": t((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
            "energy": t(rng.random((nr, naz)) * 1e-3 + 1e-3),
            "qs": t(rng.random((k_quant, nr, naz)) + 0.5),
            "dt": t(0.01), "omega": t(0.3, torch.float64)}


def radial_calls(ctx, f) -> dict:
    """The radial sweep ops on the inputs ``f`` (``radial_inputs``), each
    as (kernel call, plain call): radial_momenta_sweep on the fields with
    the context's EoS, radial_sweep on the batch; both with the sigma flux
    of the fields."""
    from .ops import kernels as K
    from .ops import transport as tr
    s, vr, dt = f["sigma"], f["vrad"], f["dt"]
    base = tr.sigma_flux(ctx.phys, ctx.g, s, vr, dt)
    rms = (s, vr, f["vaz"], f["energy"], base, dt, f["omega"])
    rs = (f["qs"], s, vr, base, dt)
    return {"radial_momenta_sweep": (
                lambda: K.radial_momenta_sweep(ctx, *rms),
                lambda: K.radial_momenta_sweep_plain(ctx, *rms)),
            "radial_sweep": (lambda: K.radial_sweep(ctx, *rs),
                             lambda: K.radial_sweep_plain(ctx, *rs))}


def edge_outputs(ops) -> dict:
    """The outputs of cfl, theta_sweep and fargo_theta (those of ``ops``)
    at each of ``EDGE_SHAPES`` in float32 and float64, on seeded random
    inputs: cfl also with a NaN and with a zero energy planted in the last
    active ring, the sweeps at K = 1, 2, 5, 6, fargo_theta with one and two
    sweeps and shifts of either sign and beyond one turn; and those of
    radial_momenta_sweep (both EoS) and radial_sweep (K = 1, 2, 5, 6) at
    each of ``RADIAL_SHAPES``, both limiters."""
    from .constants import Constants
    from .grid import Geometry
    from .ops import kernels as K
    from .params import Physics
    from .units import Units
    constants = Constants.from_units(Units())
    out = {}
    for nr, naz in EDGE_SHAPES:
        geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
        for dtype in (torch.float32, torch.float64):
            tag = f"{nr}x{naz}.{str(dtype).removeprefix('torch.')}"

            def t(a, dtype=dtype):
                return torch.tensor(a, dtype=dtype, device="cuda")
            ctx = K.KernelContext(
                Physics(eos="adiabatic", adiabatic_index=1.4,
                        viscous_alpha=1e-3, aspectratio_ref=0.05,
                        artificial_viscosity="sn"),
                constants, geometry, dtype, "cuda")
            if "cfl" in ops:
                rng = np.random.default_rng((nr, naz))
                f = [t(rng.random((nr, naz)) + 0.5),
                     t((rng.random((nr + 1, naz)) - 0.5) * 0.05),
                     t((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
                     t(rng.random((nr, naz)) * 1e-3 + 1e-3),
                     t(rng.random((nr, naz)) * 1e-6),
                     t(rng.random((nr, naz)) * 1e-6)]
                for plant in ("none", "nan", "zero_energy"):
                    g = [x.clone() for x in f]
                    if plant == "nan":
                        g[0][nr - 2, naz // 2] = float("nan")
                    elif plant == "zero_energy":
                        g[3][nr - 2, naz - 1] = 0.0
                    out[f"edge.cfl.{tag}.{plant}"] = K.cfl(ctx, *g)
            for k in (1, 2, 5, 6):
                rng = np.random.default_rng((nr, naz, k))
                qs = t(rng.random((k, nr, naz)) + 0.5)
                v = t((rng.random((nr, naz)) - 0.5) * 0.05)
                vconst = t((rng.random((nr, 1)) - 0.5) * 0.02)
                nshift = torch.tensor(
                    rng.integers(-2 * naz - 3, 2 * naz + 3, nr),
                    dtype=torch.int32, device="cuda")
                dt = t(0.01)
                if "theta_sweep" in ops:
                    out[f"edge.theta_sweep.{tag}.K{k}"] = \
                        K.theta_sweep(ctx, qs, v, dt)
                if "fargo_theta" in ops:
                    for two in (False, True):
                        out[f"edge.fargo_theta.{tag}.K{k}.two_pass{two}"] = \
                            K.fargo_theta(ctx, qs, v, vconst, nshift, dt, two)
    radial = [op for op in ("radial_momenta_sweep", "radial_sweep")
              if op in ops]
    # the radial wrappers before the column march refused NR < 4, though
    # their kernels take any NR: they are held at NR = 3 as well
    launch = K._launch
    K._launch = lambda *a, **kw: launch(*a, **{**kw, "min_nr": 3})
    try:
        for nr, naz in RADIAL_SHAPES if radial else ():
            geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
            for dtype in (torch.float32, torch.float64):
                tag = f"{nr}x{naz}.{str(dtype).removeprefix('torch.')}"
                for limiter in (0, 1):
                    for eos, k in (("adiabatic", 6), ("isothermal", 5),
                                   ("adiabatic", 1), ("adiabatic", 2)):
                        ctx = K.KernelContext(
                            Physics(eos=eos, adiabatic_index=1.4,
                                    aspectratio_ref=0.05,
                                    flux_limiter_type=limiter),
                            constants, geometry, dtype, "cuda")
                        calls = radial_calls(
                            ctx, radial_inputs(nr, naz, k, dtype, "cuda"))
                        for op in radial:
                            if op == "radial_sweep" or k >= 5:
                                out[f"edge.{op}.{tag}.K{k}.limiter"
                                    f"{limiter}"] = calls[op][0]()
    finally:
        K._launch = launch
    return out


def profile_ops(nrad: int, naz: int, save=None, against=None,
                ops=OP_NAMES) -> dict:
    from .flagship import flagship
    from .ops import kernels as K
    from .ops import transport as tr
    from .sim import Simulation
    sim = Simulation(flagship(nrad, naz), dtype="float32")
    st, ctx = sim.state, sim.stepper.ops
    g, phys = ctx.g, ctx.phys
    f = perturbed(sim)
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    dt = sim.stepper.cfl_dt(st)
    omega = st.omega_frame
    shift = tr.fargo_shift(g, va, dt)
    k = 6 if phys.is_adiabatic else 5
    plane_bytes = s.numel() * s.element_size()
    bodies = sim.stepper.bodies_on_grid(st.nbody, sim.time)
    zero = torch.zeros((), dtype=torch.float64, device=s.device)
    # the step hands the viscous kick its time as a 0-d tensor
    now = torch.zeros((), dtype=s.dtype, device=s.device)

    # op -> (call, names of its outputs)
    calls = {
        "transport": (lambda: K.transport(ctx, s, vr, va, e, omega, dt, shift,
                                          route="whole"),
                      ("sigma", "vrad", "vaz", "energy", "mass_flux")),
        "viscous_kick": (lambda: K.viscous_kick(ctx, s, vr, va, e, dt, now),
                         ("vrad", "vaz", "energy", "qplus", "qminus")),
        "sources": (lambda: K.sources(ctx, s, vr, va, e, bodies,
                                      (zero, zero), omega, dt),
                    ("vrad", "vaz")),
        "cfl": (lambda: (K.cfl(ctx, s, vr, va, e, st.qplus, st.qminus),),
                ("dt",)),
    }
    if {"radial_momenta_sweep", "radial_sweep"} & set(ops):
        # what the split and the staged route hand the radial sweeps: the
        # fields and the sigma flux, the stacked momenta
        base = tr.sigma_flux(phys, g, s, vr, dt)
        qs0 = tr.momenta_batch(phys, g, s, vr, va, e, omega.to(s.dtype))
        calls["radial_momenta_sweep"] = (
            lambda: (K.radial_momenta_sweep(ctx, s, vr, va, e, base, dt,
                                            omega),), ("qs",))
        calls["radial_sweep"] = (
            lambda: (K.radial_sweep(ctx, qs0, s, vr, base, dt),), ("qs",))
    if {"theta_sweep", "fargo_theta"} & set(ops):
        # what the staged and the split route hand the azimuthal sweeps:
        # the radially swept momenta and the residual velocity
        vmean, nshift, vconst = shift
        base = tr.sigma_flux(phys, g, s, vr, dt)
        vres = va - vmean if phys.fast_transport else va - vmean + vconst
        qs_staged = K.radial_sweep_plain(
            ctx, tr.momenta_batch(phys, g, s, vr, va, e, omega.to(s.dtype)),
            s, vr, base, dt)
        qs_split = K.radial_momenta_sweep_plain(ctx, s, vr, va, e, base, dt,
                                                omega)
        calls["theta_sweep"] = (
            lambda: (K.theta_sweep(ctx, qs_staged, vres, dt),), ("qs",))
        calls["fargo_theta"] = (
            lambda: (K.fargo_theta(ctx, qs_split, vres, vconst, nshift, dt,
                                   phys.fast_transport),), ("qs",))
    res = {"grid": f"{nrad}x{naz}", "dtype": "float32", "K": k}
    outputs = {}
    for op, (call, names) in calls.items():
        if op not in ops:
            continue
        res[op] = profile_op(call, OP_FRAGMENTS[op], k, plane_bytes)
        own = {f"{op}.{n}": t for n, t in zip(names, call())}
        res[op]["sha256"] = digest(own.values())
        outputs.update(own)

    if "advect_shift" in ops:
        # the batch as the staged route hands it to the roll
        vmean, nshift, vconst = shift
        qs = tr.momenta_batch(phys, g, s, vr, va, e, omega.to(s.dtype))
        qs = K.radial_sweep_plain(ctx, qs, s, vr,
                                  tr.sigma_flux(phys, g, s, vr, dt), dt)
        qs = K.theta_sweep_plain(ctx, qs, va - vmean, dt)
        qs = K.theta_sweep_plain(
            ctx, qs, vconst.expand_as(va).contiguous(), dt)
        j = torch.arange(naz, device=s.device)
        index = torch.remainder(j[None, :] - nshift[:, None].to(j.dtype),
                                naz).expand_as(qs).contiguous()

        def roll():
            return K.advect_shift(qs, nshift)

        res["advect_shift"] = profile_op(roll, OP_FRAGMENTS["advect_shift"],
                                         k, plane_bytes)
        outputs["advect_shift.qs"] = roll()
        res["advect_shift"]["sha256"] = digest([outputs["advect_shift.qs"]])
        if not torch.equal(roll(), torch.gather(qs, -1, index)):
            raise AssertionError("advect_shift differs from torch.gather")
        turns = {"advect_shift": [], "gather": []}
        for name in ("gather", "advect_shift", "advect_shift", "gather"):
            turns[name].append(event_ms(
                roll if name == "advect_shift"
                else lambda: torch.gather(qs, -1, index)))
        res["advect_shift"]["event_ms_in_turns"] = turns
        res["nshift_min_max"] = [int(nshift.min()), int(nshift.max())]
    if {"cfl", "theta_sweep", "fargo_theta", "radial_momenta_sweep",
            "radial_sweep"} & set(ops):
        edges = edge_outputs(ops)
        res["edge_sha256"] = digest(edges.values())
        outputs.update(edges)
    if save:
        torch.save({n: t.cpu() for n, t in outputs.items()}, save)
    if against:
        saved = torch.load(against)
        res["against"] = differences(
            {n: t for n, t in outputs.items() if n in saved}, saved)
    return res


def build_variant(defines: dict[str, int], workdir: Path) -> None:
    """Points the kernel build at a copy of ``csrc/`` in which each
    ``constexpr int NAME = <number>;`` of ``defines`` has the given number
    (an empty dict: the checkout's own sources), and loads that library in
    place of the one loaded before."""
    from .ops import kernels as K
    own = Path(__file__).resolve().parent / "csrc"
    if defines:
        K.CSRC = workdir / "_".join(f"{k}{v}" for k, v in defines.items())
        K.CSRC.mkdir()
        found = set()
        for src in own.iterdir():
            text = src.read_text()
            for name, value in defines.items():
                text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                                  rf"\g<1>{value};", text)
                if n:
                    found.add(name)
            (K.CSRC / src.name).write_text(text)
        if found != set(defines):
            raise ValueError(f"no 'constexpr int NAME = n;' for "
                             f"{sorted(set(defines) - found)} in {own}")
    else:
        K.CSRC = own
    K._LIB = None
    K.build()


def parse_defines(spec: str) -> dict[str, int]:
    """"NAME=n,NAME=n" as a dict."""
    return {k: int(v) for k, v in (kv.split("=") for kv in spec.split(",")
                                   if kv)}


def profile_variants(nrad: int, naz: int, ops, variants: str) -> list[dict]:
    """The ops' times with the checkout's kernels, with each variant of
    ``variants`` ("NAME=n,NAME=n;NAME=n;...") and with the checkout's once
    more, each in a process of its own (``--define``) on the same inputs;
    each variant's outputs held against the checkout's."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        base = str(Path(tmp) / "base.pt")
        turns = [""] + [v for v in variants.split(";") if v] + [""]
        for n, spec in enumerate(turns):
            cmd = [sys.executable, "-m", "fargocpt_torch.profile_ops",
                   "--nrad", str(nrad), "--naz", str(naz), "--ops",
                   ",".join(ops), "--save" if n == 0 else "--against", base]
            if spec:
                cmd += ["--define", spec]
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=Path(__file__).resolve().parent.parent)
            if out.returncode != 0:
                rows.append({"variant": spec, "failed": out.stderr[-400:]})
                continue
            res = json.loads(out.stdout.strip().splitlines()[-1])
            rows.append({"variant": spec or "checkout", **{
                op: {"device_ms": res[op]["device_ms"],
                     "event_ms": res[op]["event_ms"]} for op in ops},
                "values_that_differ": sum(
                    d["values_that_differ"]
                    for d in res.get("against", {}).values())})
    return rows


def profile_steps(nrad: int, naz: int, routes=("whole",)) -> dict:
    """Wall and device time a step of the flagship on each of ``routes``
    (keys "flagship" for the whole route, "flagship_<route>" for another)
    and of the PDS70 gas setup."""
    from .profile_step import profile_grid
    out = {}
    runs = [("flagship" if r == "whole" else f"flagship_{r}", "flagship", r,
             dict(warmup=20, steps=120, window=20)) for r in routes]
    runs.append(("pds70_gas", "pds70_gas", "whole",
                 dict(warmup=5, steps=15, window=8)))
    for name, setup, route, kw in runs:
        r = profile_grid(nrad, naz, setup, route=route, **kw)
        out[name] = {
            "wall_ms_per_step": r["wall_ms_per_step"],
            "device_ms_per_step": r["device_ms_per_step"],
            "device_busy_share": r["device_busy_share"],
            "ops": {op: {"device_ms_per_step": row["device_ms_per_step"],
                         "launches_per_step": row["launches_per_step"]}
                    for op, row in r["ops"].items()}}
    return out


MUFU_KINDS = {"rcp": "MUFU.RCP", "sqrt": "MUFU.SQRT", "rsq": "MUFU.RSQ",
              "ex2": "MUFU.EX2"}


def sass_counts(names=("transport", "advect_shift", "viscous_kick",
                       "sources", "cfl", "theta_sweep", "fargo_theta",
                       "radial_momenta_sweep", "radial_sweep")) -> dict:
    """Per kernel of csrc/<name>.cu: registers, spills and shared memory
    from ``nvcc -Xptxas -v``; SASS operations and, among them, reciprocals,
    square roots, reciprocal square roots and exponentials (``MUFU_KINDS``;
    the 64H forms of float64 count with their kind) from
    ``cuobjdump -sass``."""
    from .ops import kernels as K
    nvcc = K.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            obj = Path(tmp) / f"{name}.o"
            res = subprocess.run(
                [nvcc, *K.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(K.CSRC / f"{name}.cu"), "-o", str(obj)],
                capture_output=True, text=True, check=True)
            kernels = {}
            current = None
            for line in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    current = kernels.setdefault(m.group(1), {})
                    continue
                if current is None:
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    current["registers"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", line)
                    current["smem_bytes"] = int(sm.group(1)) if sm else 0
            sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                                  capture_output=True, text=True, check=True)
            current = None
            for line in sass.stdout.splitlines():
                m = re.search(r"Function : (\w+)", line)
                if m:
                    current = kernels.setdefault(m.group(1), {})
                    current.update(sass_ops=0, **{k: 0 for k in MUFU_KINDS})
                    continue
                if current is None or not re.search(r"/\*[0-9a-f]{4}\*/",
                                                    line):
                    continue
                current["sass_ops"] += 1
                for kind, op in MUFU_KINDS.items():
                    if op in line:
                        current[kind] += 1
            out[name] = kernels
    return out


def report(args, ops, gpu) -> dict:
    """Measures and prints what ``args`` ask for; returns all of it."""
    res = {"gpu": gpu, **profile_ops(args.nrad, args.naz, args.save,
                                     args.against, ops)}
    for op in ops:
        r = res[op]
        print(f"{op} {res['grid']} float32 K={res['K']}: events "
              f"{r['event_ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"wrapper {r['wrapper_ms']:.4f} ms, host {r['host_ms']:.4f} ms,"
              f" {r['pytorch_launches']:.1f} other device launches a call, "
              f"outputs {r['sha256']} [{gpu}]", flush=True)
        for row in r["launches"]:
            rate = f"{row['bytes'] / 1e6:.1f} MB (bound " \
                f"{row['bound_ms']:.4f} ms), {row['tb_per_s']:.3f} " \
                f"TB/s = {100 * row['share_of_memory_rate']:.1f}% of " \
                f"{HBM_BYTES_PER_S / 1e12} TB/s" if "bytes" in row else ""
            print(f"    {row['kernel']:28s} {row['device_ms']:.4f} ms  {rate}",
                  flush=True)
    if "advect_shift" in ops:
        print(f"advect_shift against torch.gather with a prebuilt index, "
              f"event medians in turns: "
              f"{res['advect_shift']['event_ms_in_turns']} [{gpu}]",
              flush=True)
    if "edge_sha256" in res:
        print(f"tile-edge outputs {res['edge_sha256']} [{gpu}]", flush=True)
    if args.against:
        own = {n: d for n, d in res["against"].items()
               if not n.startswith("edge.")}
        edge = [d for n, d in res["against"].items() if n.startswith("edge.")]
        print(f"outputs against {args.against}: {own}; tile-edge outputs: "
              f"{len(edge)} held, "
              f"{sum(d['values_that_differ'] for d in edge)} values differ",
              flush=True)
    if args.steps:
        res["steps"] = profile_steps(args.nrad, args.naz,
                                     tuple(args.routes.split(",")))
        for setup, r in res["steps"].items():
            print(f"{setup} step {res['grid']} float32: wall "
                  f"{r['wall_ms_per_step']:.4f} ms, device "
                  f"{r['device_ms_per_step']:.4f} ms, "
                  f"{sum(x['launches_per_step'] for x in r['ops'].values()):.2f}"
                  f" launches a step; "
                  + "; ".join(f"{op} {x['launches_per_step']:.2f} launches "
                              f"{x['device_ms_per_step']:.4f} ms"
                              for op, x in r["ops"].items())
                  + f" [{gpu}]", flush=True)
    if args.variants:
        res["variants"] = profile_variants(args.nrad, args.naz, ops,
                                           args.variants)
        for row in res["variants"]:
            if "failed" in row:
                print(f"  variant {row['variant']} failed: {row['failed']}",
                      flush=True)
                continue
            print(f"  variant {row['variant']}: "
                  + "; ".join(f"{op} device {row[op]['device_ms']:.4f} ms, "
                              f"events {row[op]['event_ms']:.4f} ms"
                              for op in ops)
                  + f"; {row['values_that_differ']} values differ from the "
                  f"checkout's [{gpu}]", flush=True)
    if args.sass:
        res["sass"] = sass_counts()
        for name, kernels in res["sass"].items():
            for kernel, row in kernels.items():
                m = re.search(r"\d([a-z_]+?_kernel)I(\w+?)E", kernel)
                label = f"{m.group(1)}<{m.group(2)}>" if m else kernel[:60]
                print(f"  {name}.cu {label}: {row}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nrad", type=int, default=1024)
    ap.add_argument("--naz", type=int, default=3072)
    ap.add_argument("--ops", default=",".join(OP_NAMES),
                    help="the ops to take, comma-separated (default: all)")
    ap.add_argument("--steps", action="store_true",
                    help="also the flagship and PDS70 gas steps")
    ap.add_argument("--routes", default="whole",
                    help="the flagship step's transport routes with --steps, "
                    "comma-separated (default: whole)")
    ap.add_argument("--sass", action="store_true",
                    help="also registers, spills and SASS operation counts")
    ap.add_argument("--save", help="write the ops' outputs to this file")
    ap.add_argument("--against", help="hold the ops' outputs against the "
                    "set saved in this file")
    ap.add_argument("--define", help="take the ops with this variant of "
                    'the CUDA sources, e.g. "VK_TH=8,VK_TW=128"')
    ap.add_argument("--variants", help='variants of the CUDA sources to '
                    'take the ops with, e.g. "VK_TH=8;VK_TH=32,VK_TW=128"')
    args = ap.parse_args(argv)
    ops = tuple(args.ops.split(","))
    if set(ops) - set(OP_NAMES):
        ap.error(f"--ops takes names of {OP_NAMES}")
    if not torch.cuda.is_available():
        print("profile_ops: needs a CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if args.define:
            build_variant(parse_defines(args.define), Path(tmp))
        res = report(args, ops, gpu)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

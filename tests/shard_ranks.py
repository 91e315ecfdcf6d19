"""Helpers of the sharded-step tests (tests/test_torch_shard.py,
tests/test_torch_shard_output.py): the configurations of
tests/test_shard_map.py on the port, and the functions the ranks run.

The ranks are processes that ``fargocpt_torch.parallel.launch`` spawns
with the gloo backend on the CPU, one thread each; they meet at a file in
the test's ``tmp_path``, so tests in parallel never share a port. This
module imports no JAX: every rank imports it afresh. A rank function
returns numpy arrays, which the test holds against the single-process run
(computed on each rank, so both come from the same process) and against
the JAX package's ``ShardedHydroStep``.
"""

import itertools

import numpy as np
import torch

from fargocpt_torch.config import Config
from fargocpt_torch.parallel.launch import launch
from fargocpt_torch.parallel.shard_step import ShardedHydroStep
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import system_state_to_numpy

# tests/test_shard_map.py flagship_config
FLAGSHIP = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25", "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5", "HeatingViscous": "Yes",
    "CoolingBetaLocal": "Yes", "CoolingBeta": "10",
    "ArtificialViscosity": "SN", "Nrad": "192", "Naz": "64", "Rmin": "0.4",
    "Rmax": "2.5", "RadialSpacing": "Log", "InnerBoundary": "outflow",
    "OuterBoundary": "outflow", "Transport": "FARGO", "Nsnapshots": "1",
    "Nmonitor": "1", "MonitorTimestep": "0.5", "FirstDT": "1e-4"}

# the physics cases of tests/test_shard_map.py, each stepped three times
# on dt 1e-4
CASES = {
    "planet": {
        "EquationOfState": "Isothermal", "DiskFeedback": "yes",
        "Frame": "C", "CorotationReferenceBody": "1",
        "nbody": [
            {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "planet", "semi-major axis": "1.0", "mass": "1e-3",
             "accretion efficiency": "1.0", "accretion method": "kley"}]},
    "damping": {"Damping": "Yes", "DampingInnerLimit": "1.10",
                "DampingOuterLimit": "0.90", "DampingTimeFactor": "10"},
    "fld": {"Sigma0": "2000 g/cm2", "CoolingBetaLocal": "No",
            "SurfaceCooling": "thermal", "RadiativeDiffusion": "Yes",
            "RadiativeDiffusionMaxIterations": "300",
            "RadiativeDiffusionAutoOmega": "Yes"},
    "selfgravity": {"Sigma0": "5000 g/cm2", "SelfGravity": "Yes",
                    "SelfGravityMode": "symmetric",
                    "WriteAlphaGravMean": "Yes"},
    "particles": {"IntegrateParticles": "yes", "NumberOfParticles": "32",
                  "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "2",
                  "ParticleDustDiffusion": "yes"},
    "buckets": {"IntegrateParticles": "yes", "NumberOfParticles": "64",
                "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "2"},
    # the leapfrog (its kick-drift-kick gas, two bucket migrations a step)
    "leapfrog": {"Integrator": "Leapfrog", "IntegrateParticles": "yes",
                 "NumberOfParticles": "64", "ParticleRadius": "1 cm",
                 "ParticleSpeciesNumber": "2"},
    # the slow cases of tests/test_shard_map.py
    "composite": {
        "RocheLobeOverflow": "Yes", "ROFValue": "1e-9 solMass/yr",
        "ROFPlanet": "1", "ROFTemperature": "4000",
        "OuterBoundary": "centerofmass",
        "nbody": [
            {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "donor", "semi-major axis": "1.0", "mass": "0.5"}]},
    "pvte": {
        "EquationOfState": "PVTE", "HydrogenMassFraction": "0.75",
        "Sigma0": "2000 g/cm2", "CoolingBetaLocal": "No",
        "SurfaceCooling": "thermal", "RadiativeDiffusion": "Yes",
        "RadiativeDiffusionMaxIterations": "300", "SelfGravity": "Yes",
        "SelfGravityMode": "symmetric", "IntegrateParticles": "yes",
        "NumberOfParticles": "32", "ParticleRadius": "1 cm",
        "ParticleSpeciesNumber": "2"},
}
# the replicated swarm (the JAX package's shard_particles=False)
REPLICATED = ("particles",)
FIELDS = ("sigma", "vrad", "vaz", "energy")
_store = itertools.count()


def config(extra=None, **over) -> dict:
    cfg = dict(FLAGSHIP)
    cfg.update(extra or {})
    cfg.update({k: str(v) for k, v in over.items()})
    return cfg


def port_sim(cfg: dict, dtype="float64", device="cpu") -> Simulation:
    return Simulation(Config.from_dict(dict(cfg)), dtype=dtype,
                      device=device)


def rel(a, b) -> float:
    """Largest difference over the largest magnitude (the gate of
    tests/test_shard_map.py)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def spawn(fn, n, tmp_path, *args):
    """``fn(comm, *args)`` on n gloo ranks on the CPU."""
    store = tmp_path / f"store{next(_store)}"
    return launch(fn, n, backend="gloo", device="cpu", args=args,
                  init_method=f"file://{store}", threads=1)


def np_state(state) -> dict:
    return system_state_to_numpy(state)


def draw(n, seed=5) -> np.ndarray:
    """The shared standard-normal draw of the diffusing swarm's kicks."""
    return np.random.default_rng(seed).standard_normal(n)


# --- rank functions ----------------------------------------------------
def rank_flagship(comm, extra, interval=True):
    """The flagship: the CFL, one step of 2e-4 and a monitor interval to
    0.5, each single-process and sharded, with the bytes each sent."""
    sim = port_sim(config(extra))
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    out = {"cfl": (float(sim.stepper.cfl_dt(sim.state)),
                   float(ss.cfl_dt(local)))}
    comm.reset_counters()
    loc = ss.step(local, 0.0, 2e-4)
    out["step_bytes"] = dict(comm.bytes_sent)
    g = ss.gather(loc)
    s1 = sim.stepper.step(sim.state, 0.0, 2e-4)
    out["step"] = (np_state(s1), np_state(g))
    out["model"] = ss.comm_model()
    if interval:
        o1 = sim.stepper.advance_to(sim.state, 0.0, 1e-4, 0.5)
        comm.reset_counters()
        o2 = ss.advance_to(local, 0.0, 1e-4, 0.5)
        out["interval_bytes"] = dict(comm.bytes_sent)
        out["interval"] = (
            (o1[3], float(o1[1]), float(o1[2]), np_state(o1[0])),
            (o2[3], float(o2[1]), float(o2[2]), np_state(ss.gather(o2[0]))))
    return out


def rank_case(comm, name, steps=3, dtype="float64"):
    """A case of ``CASES`` stepped ``steps`` times on dt 1e-4,
    single-process and sharded, on the communicator's device; the
    diffusing swarm on the shared draw."""
    extra = CASES[name]
    if extra.get("ParticleDustDiffusion") == "yes":
        from fargocpt_torch.particles import dust
        fixed = draw(int(extra["NumberOfParticles"]))
        dust.standard_normal = lambda st: torch.tensor(
            fixed, dtype=st.r.dtype, device=st.r.device)
    sim = port_sim(config(extra), dtype=dtype, device=comm.device)
    ss = ShardedHydroStep(sim.stepper, comm,
                          shard_particles=name not in REPLICATED)
    local = ss.shard_state(sim.state)
    s1 = sim.state
    comm.reset_counters()
    for i in range(steps):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        local = ss.step(local, i * 1e-4, 1e-4)
    out = {"bytes": dict(comm.bytes_sent), "model": ss.comm_model(),
           "overflow": ss.overflow(local)}
    if name in ("buckets",):
        sp = local.particles
        out["pids"] = sp.pid[sp.valid].cpu().numpy()
    if sim.stepper.fld is not None:
        out["fld_iterations"] = (sim.stepper.fld.iterations,
                                 ss.window.fld.iterations)
    out["states"] = (np_state(s1), np_state(ss.gather(local)))
    return out


def rank_cases(comm, names, dtype="float64"):
    """``rank_case`` of each name in turn."""
    return [rank_case(comm, name, dtype=dtype) for name in names]


def rank_refusals(comm):
    """What ShardedHydroStep refuses on ``comm``'s ranks: NR not a
    multiple of the rank count, and (on one rank) a window past the grid.
    Returns the error messages."""
    msgs = []
    nrad = 193 if comm.size > 1 else 192
    sim = port_sim(config(Nrad=nrad))
    try:
        ShardedHydroStep(sim.stepper, comm)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def rank_migrate(comm, slots, lo, hi, E):
    """``particles.sharded.migrate`` of this rank's share of ``slots``
    (name -> (n C,) numpy array, ``overflow`` (n,)), the slabs' bounds
    ``lo``, ``hi``; returns this rank's slots after it."""
    from fargocpt_torch.particles import sharded as psh
    n, k = comm.size, comm.rank
    C = slots["r"].shape[0] // n
    mine = {name: torch.tensor(a[k * C:(k + 1) * C])
            for name, a in slots.items() if name != "overflow"}
    mine["overflow"] = torch.tensor(slots["overflow"][k], dtype=torch.int32)
    out = psh.migrate(mine, float(lo[k]), float(hi[k]), k == n - 1, k == 0,
                      E, comm)
    return {name: v.numpy() for name, v in out.items()}


def rank_write_rows(comm, cfg, outdir, dtype="float64", steps=1):
    """A sharded snapshot of ``cfg`` after ``steps`` steps of 1e-4 on
    ``comm``'s ranks (DistributedOutput); returns the global state."""
    from fargocpt_torch import output as tout
    sim = port_sim(cfg, dtype=dtype)
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    for i in range(steps):
        local = ss.step(local, i * 1e-4, 1e-4)
    writer = tout.OutputWriter(sim, outdir) if comm.rank == 0 else None
    comm.barrier()
    sim.n_snapshot = 1
    tout.write_sharded_snapshot(sim, ss, local, outdir, writer)
    return np_state(ss.gather(local))


def rank_run(comm, cfg, outdir):
    """``parallel.run`` of ``cfg`` with output to ``outdir``; returns the
    gathered final state and the step count."""
    from fargocpt_torch.parallel import run as prun
    sim = port_sim(cfg, device=comm.device)
    prun.run(sim, comm, outdir)
    return np_state(sim.state), sim.n_hydro_iter


def monitor_record(sim):
    """A monitor hook's record: the counters, the time and sigma."""
    return (sim.n_monitor, sim.n_snapshot, float(sim.time),
            sim.state.fields.sigma.cpu().numpy().copy())


def rank_run_hooks(comm, cfg, max_steps=None):
    """``parallel.run`` of ``cfg`` without output, a monitor hook of the
    caller's registered first; the hook's records and the step count."""
    from fargocpt_torch.parallel import run as prun
    sim = port_sim(cfg, device=comm.device)
    records = []
    sim.monitor_hooks.append(lambda s: records.append(monitor_record(s)))
    prun.run(sim, comm, max_steps=max_steps)
    return records, sim.n_hydro_iter


def rank_restore(comm, cfg, outdir, sid, steps=0):
    """A fresh run of ``cfg`` restored from snapshot ``sid`` of ``outdir``
    on every rank, sharded, ``steps`` steps of 1e-4 taken, gathered."""
    from fargocpt_torch import output as tout
    sim = port_sim(cfg, device=comm.device)
    tout.restore_simulation(sim, outdir, sid)
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    for i in range(steps):
        local = ss.step(local, float(sim.time) + i * 1e-4, 1e-4)
    return np_state(ss.gather(local)), float(sim.time), sim.n_hydro_iter


def rank_roundtrip(comm):
    """A swarm bucketed over the ranks and gathered back, beside itself."""
    from fargocpt_torch.particles import dust, sharded as psh
    radii = np.geomspace(0.4, 2.5, 65)
    ps = dust.init_particles(40, 0.45, 2.4, 0.5, 1e-5, 1.0, seed=7)
    sp, _, _, _ = psh.shard_particles(ps, comm.size, 16, radii, comm.rank)
    back = psh.gather_particles(sp, comm, 40, ps)
    return {name: (getattr(back, name).numpy(), getattr(ps, name).numpy())
            for name in psh._FIELDS + ("alive",)}


def rank_comm_ops(comm):
    """The communicator's collectives on this rank's device: an exchange,
    a sum, a min, a gather and a broadcast; host copies of the results,
    the device they came back on and the bytes sent."""
    dev, k = comm.device, comm.rank
    x = torch.arange(12, dtype=torch.float64, device=dev).reshape(3, 4) \
        + 100.0 * k
    below, above = comm.exchange(x[1:], x[:2])
    outs = {"below": below, "above": above,
            "sum": comm.sum(torch.tensor([1.0 + k, 2.0 * k],
                                         dtype=torch.float64, device=dev)),
            "min": comm.min(torch.tensor([5.0 - k], dtype=torch.float64,
                                         device=dev)),
            "gather": comm.gather_rows(x[:1]),
            "broadcast": comm.broadcast(x, comm.size - 1)}
    return ({name: t.cpu().numpy() for name, t in outs.items()},
            {t.device.type for t in outs.values()}, dict(comm.bytes_sent))


def rank_flagship_step(comm, dtype="float64"):
    """One step of 2e-4 of the flagship at 192x64 on this rank's device,
    sharded and single-process; each grid's largest difference over its
    scale, and the kernels the sharded step launched."""
    from fargocpt_torch.ops import kernels as K
    sim = port_sim(config(), dtype=dtype, device=comm.device)
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    K.reset_launches()
    local = ss.step(local, 0.0, 2e-4)
    launches = dict(K.LAUNCHES)
    one = np_state(sim.stepper.step(sim.state, 0.0, 2e-4))
    many = np_state(ss.gather(local))
    keys = ("fields.sigma", "fields.vrad", "fields.vaz", "fields.energy",
            "qplus", "qminus")
    return {key: rel(one[key], many[key]) for key in keys}, launches

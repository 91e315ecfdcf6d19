"""The sharded dust's migration and overflow counter, and the row files of
a sharded run (DistributedOutput), on gloo ranks on the CPU against the
JAX package.

* The migration exchange on crafted positions, as tests/test_shard_map.py
  runs it for the JAX package: the same slots come out of both packages,
  and ``overflow`` stays 0; with too few buffer or free slots both count
  the same dropped particles.
* The row files of a sharded snapshot equal the JAX package's
  ``write_sharded_array`` on the same state, sharded as many ways over
  host devices, byte for byte (v_rad, which the JAX package keeps whole,
  reads back to the same array both ways); a sharded run's files equal
  the single-process run's, row files reassembled.
* Restores across the packages: the JAX package's row files onto one
  device and onto n ranks, the port's into the JAX package, bit for bit.
* One device with DistributedOutput writes the serial layout (the JAX
  package's rule, fargocpt_tpu/output.py:258-259): the same bytes as
  without it, and as the JAX package's files.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from fargocpt_tpu import output as jout
from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.parallel import mesh as jmesh
from fargocpt_tpu.particles import sharded as jpsh
from fargocpt_tpu.parallel.shard_step import _shard_map
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import flagship
from fargocpt_torch import output as tout
from fargocpt_torch.config import Config
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import system_state_from_numpy, \
    system_state_to_numpy

import shard_ranks as sr

torch.set_num_threads(2)

N, C = 4, 4


def crafted(overflow: bool):
    """Slots of 4 ranks, rank k owning radii [k, k+1): a stayer in slot 0
    of each; rank 1 holds an up-crosser (pid 100) and a down-crosser
    (pid 200). With ``overflow`` rank 1 holds a second up-crosser (pid
    101) and rank 2 has no free slot."""
    r = np.zeros(N * C)
    valid = np.zeros(N * C, bool)
    pid = np.full(N * C, -1, np.int32)
    for k in range(N):
        r[k * C], valid[k * C], pid[k * C] = k + 0.5, True, k
    for slot, rr, p in ((1, 2.2, 100), (2, 0.7, 200)):
        r[C + slot], valid[C + slot], pid[C + slot] = rr, True, p
    if overflow:
        r[C + 3], valid[C + 3], pid[C + 3] = 2.4, True, 101
        for slot in (1, 2, 3):
            s = 2 * C + slot
            r[s], valid[s], pid[s] = 2.5, True, 300 + slot
    slots = {name: np.where(valid, r, 0.0) if name == "r"
             else np.where(valid, 0.1 * (i + 1) * np.arange(N * C), 0.0)
             for i, name in enumerate(jpsh._FIELDS)}
    slots.update(alive=valid.copy(), valid=valid, pid=pid,
                 overflow=np.zeros(N, np.int32))
    lo = np.arange(N, dtype=np.float64)
    hi = lo + 1.0
    lo[0], hi[-1] = -np.inf, np.inf
    return slots, lo, hi


def jax_migrate(slots, lo, hi, E):
    """The JAX package's ``migrate`` under shard_map on N host devices
    (tests/test_shard_map.py ``test_particle_migration_exchange``)."""
    mesh = jmesh.make_mesh(N)
    leaves = {k: jnp.asarray(v) for k, v in slots.items()}
    is_top = (np.arange(N) == N - 1).astype(np.float64)
    is_bot = (np.arange(N) == 0).astype(np.float64)

    def fn(lv, lo_, hi_, top_, bot_):
        spl = {k: v for k, v in lv.items() if k != "overflow"}
        spl["overflow"] = lv["overflow"][0]
        out = jpsh.migrate(spl, lo_[0], hi_[0], top_[0], bot_[0], E, "r", N)
        out["overflow"] = out["overflow"][None]
        return out

    specs = {k: P("r") for k in leaves}
    mapped = jax.jit(_shard_map(fn, mesh, in_specs=(specs, P("r"), P("r"),
                                                    P("r"), P("r")),
                                out_specs=specs))
    out = mapped(leaves, jnp.asarray(lo), jnp.asarray(hi),
                 jnp.asarray(is_top), jnp.asarray(is_bot))
    return {k: np.asarray(v) for k, v in out.items()}


def port_migrate(tmp_path, slots, lo, hi, E):
    res = sr.spawn(sr.rank_migrate, N, tmp_path, slots, lo, hi, E)
    out = {k: np.concatenate([r[k] for r in res])
           for k in res[0] if k != "overflow"}
    out["overflow"] = np.asarray([int(r["overflow"]) for r in res])
    return out


@pytest.mark.parametrize("overflow", [False, True])
def test_migration_matches_jax(overflow, tmp_path):
    """The crossers land in the right neighbour's free slots, pids and
    payload kept, source slots freed, the census kept (no overflow); with
    one buffer slot and a full receiver both packages drop the same two
    particles, counted on the same ranks."""
    slots, lo, hi = crafted(overflow)
    E = 1 if overflow else 2
    got = port_migrate(tmp_path, slots, lo, hi, E)
    want = jax_migrate(slots, lo, hi, E)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)
    if not overflow:
        assert got["overflow"].sum() == 0
        s2, s0 = slice(2 * C, 3 * C), slice(0, C)
        assert 100 in got["pid"][s2] and 200 in got["pid"][s0]
        assert not got["valid"][C + 1] and not got["valid"][C + 2]
        assert got["valid"].sum() == slots["valid"].sum()
    else:
        np.testing.assert_array_equal(got["overflow"], [0, 1, 1, 0])
        assert got["valid"].sum() == slots["valid"].sum() - 2


def test_bucket_gather_roundtrip(tmp_path):
    """Bucketing a swarm over 4 ranks and gathering it back is the
    identity (tests/test_shard_map.py ``test_shard_gather_particles_
    roundtrip``)."""
    res = sr.spawn(sr.rank_roundtrip, 4, tmp_path)
    for r in res:
        for name, (a, b) in r.items():
            np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_rows(arr, n, sdir, base):
    sharding = NamedSharding(jmesh.make_mesh(n), P("r", None))
    jout.write_sharded_array(jax.device_put(jnp.asarray(arr), sharding),
                             sdir, base)


def test_row_files_equal_the_jax_writer(tmp_path):
    """The row files of one state split over 2 ranks: the prognostic
    grids, Q+ / Q- (float64 flagship) and the PVTE cache (float32 PVTE,
    BitwiseExactRestarting) are the JAX writer's bytes; v_rad reads back
    to the same array both ways."""
    flag = sr.config(None, BitwiseExactRestarting="yes",
                     DistributedOutput="yes")
    pvte = sr.config(sr.CASES["pvte"], BitwiseExactRestarting="yes",
                     DistributedOutput="yes", IntegrateParticles="no")
    cases = ((flag, "float64", ("Sigma", "vazi", "energy", "Qplus",
                                "Qminus")),
             (pvte, "float32", ("PvteGeff", "PvteMu")))
    for i, (cfg, dtype, names) in enumerate(cases):
        port = tmp_path / f"port{i}"
        res = sr.spawn(sr.rank_write_rows, 2, tmp_path, cfg, port, dtype)
        state = res[0]
        pdir = port / "snapshots" / "1"
        jdir = tmp_path / f"jax{i}"
        jdir.mkdir()
        keys = {"Sigma": "fields.sigma", "vazi": "fields.vaz",
                "energy": "fields.energy", "Qplus": "qplus",
                "Qminus": "qminus", "PvteGeff": "pvte_guess.0",
                "PvteMu": "pvte_guess.1", "vrad": "fields.vrad"}
        for name in names:
            _jax_rows(state[keys[name]], 2, jdir, name)
            jfiles = sorted(p.name for p in jdir.glob(f"{name}.r*"))
            assert jfiles == sorted(p.name for p in pdir.glob(f"{name}.r*"))
            assert len(jfiles) == 2
            for f in jfiles:
                assert (jdir / f).read_bytes() == (pdir / f).read_bytes(), f
        if i == 0:
            vrad = state["fields.vrad"]
            # the JAX package keeps v_rad (NR+1 rows) whole
            jv = jout.read_sharded_array(
                pdir, "vrad", vrad.shape,
                NamedSharding(jmesh.make_mesh(2), P()), jnp.float64)
            np.testing.assert_array_equal(np.asarray(jv), vrad)
            jout.write_sharded_array(jax.device_put(jnp.asarray(vrad)), jdir,
                                     "vrad")
            np.testing.assert_array_equal(
                tout.read_rows(jdir, "vrad", vrad.shape), vrad)


def _small(extra=None, **over):
    """The flagship at 64x32, two snapshots of one monitor of 0.02."""
    return sr.config(extra, **{"Nrad": 64, "Naz": 32, "Nsnapshots": 2,
                               "MonitorTimestep": 0.02, **over})


def test_sharded_run_writes_the_serial_files(tmp_path):
    """A run on 2 ranks (``parallel.run``): with DistributedOutput its
    row files, 1-D files, misc.bin, nbody.bin and monitor files are the
    single-process run's bytes; without it, the serial layout itself."""
    serial = tmp_path / "serial"
    sim = Simulation(Config.from_dict(_small(DistributedOutput="yes")),
                     device="cpu")
    w = tout.OutputWriter(sim, serial)
    sim.run()
    w.close()
    for flag in ("yes", "no"):
        out = tmp_path / f"rows_{flag}"
        res = sr.spawn(sr.rank_run, 2, tmp_path,
                       _small(DistributedOutput=flag), out)
        assert res[0][1] == sim.n_hydro_iter
        for sid in ("0", "1", "2"):
            a, b = serial / "snapshots" / sid, out / "snapshots" / sid
            for f in sorted(a.iterdir()):
                if f.name == "config.yml":
                    continue          # the setups differ in the flag
                if flag == "yes" and f.name.endswith(".dat") \
                        and not f.name.endswith("1D.dat"):
                    base = f.name[:-4]
                    rows = tout.row_files(b, base)
                    assert [(r0, r1) for r0, r1, _ in rows] == [
                        (0, 32), (32, 65 if base == "vrad" else 64)]
                    assert not (b / f.name).exists()
                    got = b"".join(p.read_bytes() for _, _, p in rows)
                else:
                    got = (b / f.name).read_bytes()
                assert got == f.read_bytes(), f"{flag} {sid} {f.name}"
        for name in ("Quantities.dat", "nbody0.dat"):
            assert (serial / "monitor" / name).read_bytes() \
                == (out / "monitor" / name).read_bytes(), name
        # the dt statistics, beside the wall times (columns 3 and 4)
        a, b = (np.loadtxt(d / "monitor" / "timestepLogging.dat")
                for d in (serial, out))
        np.testing.assert_array_equal(np.delete(a, [3, 4], axis=1),
                                      np.delete(b, [3, 4], axis=1))


def test_sharded_run_keeps_the_simulations_hooks_and_step_limit(tmp_path):
    """``parallel.run`` is ``Simulation.run`` with the sharded advancer: a
    monitor hook the caller registered sees at every monitor boundary the
    counters, time and sigma one process's run shows it (sigma to the
    sharded interval's 1e-11), and ``max_steps`` stops both runs at the
    same step, past a monitor boundary and short of the next."""
    cfg = _small(None, Nsnapshots=3)
    for limit in (None, 20):
        sim = Simulation(Config.from_dict(dict(cfg)), device="cpu")
        records = []
        sim.monitor_hooks.append(
            lambda s: records.append(sr.monitor_record(s)))
        sim.run(limit)
        res = sr.spawn(sr.rank_run_hooks, 2, tmp_path, cfg, limit)
        assert sim.n_hydro_iter == limit if limit else len(records) == 4
        for got, n in res:
            assert n == sim.n_hydro_iter
            assert len(got) == len(records)
            for a, b in zip(records, got):
                assert a[:3] == b[:3]
                assert sr.rel(a[3], b[3]) < 1e-11


def test_row_files_restore_across_packages(tmp_path):
    """The JAX package's row files (its GSPMD run on 2 host devices)
    restore into the port on one device and on 2 ranks; the port's row
    files (a run on 2 ranks) restore into the JAX package; each bit for
    bit the other package's own restore."""
    cfg = _small(None, DistributedOutput="yes", Nsnapshots=1)
    jsim = JSimulation(JConfig.from_dict(dict(cfg)),
                       outdir=str(tmp_path / "j"))
    jsim.state = jmesh.shard_state(jsim.state, jmesh.make_mesh(2))
    jout.OutputWriter(jsim)
    jsim.run()
    jdir = tmp_path / "j" / "snapshots" / "1"
    assert not (jdir / "Sigma.dat").exists()
    assert len(list(jdir.glob("Sigma.r*"))) == 2

    # the JAX package's restore of its own files, one device
    jr = JSimulation(JConfig.from_dict(dict(cfg)))
    jout.restore_simulation(jr, tmp_path / "j", 1)
    one = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    tout.restore_simulation(one, tmp_path / "j", 1)
    flat = system_state_to_numpy(one.state)
    for key, arr in (("fields.sigma", jr.fields.sigma),
                     ("fields.vrad", jr.fields.vrad),
                     ("fields.vaz", jr.fields.vaz),
                     ("fields.energy", jr.fields.energy),
                     ("qplus", jr.state.qplus), ("qminus", jr.state.qminus)):
        np.testing.assert_array_equal(flat[key], np.asarray(arr), err_msg=key)
    assert float(one.time) == float(jr.time)
    assert one.n_hydro_iter == jr.n_hydro_iter

    res = sr.spawn(sr.rank_restore, 2, tmp_path, cfg, tmp_path / "j", 1)
    for key in ("fields.sigma", "fields.vrad", "fields.vaz", "fields.energy",
                "qplus", "qminus"):
        np.testing.assert_array_equal(res[0][0][key], flat[key], err_msg=key)
    assert res[0][1] == float(one.time)

    # the port's row files into the JAX package
    res = sr.spawn(sr.rank_run, 2, tmp_path, cfg, tmp_path / "p")
    pdir = tmp_path / "p" / "snapshots" / "1"
    assert len(tout.row_files(pdir, "Sigma")) == 2
    jp = JSimulation(JConfig.from_dict(dict(cfg)))
    jout.restore_simulation(jp, tmp_path / "p", 1)
    pp = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    tout.restore_simulation(pp, tmp_path / "p", 1)
    flat = system_state_to_numpy(pp.state)
    for key, arr in (("fields.sigma", jp.fields.sigma),
                     ("fields.vrad", jp.fields.vrad),
                     ("fields.vaz", jp.fields.vaz),
                     ("fields.energy", jp.fields.energy)):
        np.testing.assert_array_equal(np.asarray(arr), flat[key], err_msg=key)
        np.testing.assert_array_equal(flat[key], res[0][0][key], err_msg=key)
    assert jp.n_hydro_iter == pp.n_hydro_iter == res[0][1]


class _Capture:
    """The JAX run's state and counters at each monitor, before its
    writer's hooks."""

    def __init__(self):
        self.records = []

    def __call__(self, sim):
        tree = {"fields.sigma": sim.fields.sigma,
                "fields.vrad": sim.fields.vrad, "fields.vaz": sim.fields.vaz,
                "fields.energy": sim.fields.energy,
                "qplus": sim.state.qplus, "qminus": sim.state.qminus}
        nb = sim.state.nbody
        tree.update({f"nbody.{k}": getattr(nb, k)
                     for k in ("x", "y", "vx", "vy", "mass")})
        tree.update({k: getattr(sim.state, k) for k in (
            "omega_frame", "frame_angle", "corot_ref_x", "corot_ref_y")})
        tree["monitor_acc.mass_delta"] = sim.state.monitor_acc.mass_delta
        self.records.append({
            "tree": {k: np.array(v) for k, v in tree.items()},
            "time": sim.time, "last_dt": sim.last_dt,
            "n_monitor": sim.n_monitor, "n_hydro_iter": sim.n_hydro_iter,
            "monitor_stats": dict(sim.monitor_stats)})


def test_distributed_output_on_one_device_writes_the_serial_layout(
        tmp_path):
    """``setups/spreading_ring.yml`` at 16x32, float64, one device: with
    DistributedOutput the port writes the serial files, byte for byte
    those without it, both from its own run and from the JAX run's states
    (carried into it), and those the JAX package writes."""
    def cfg(flag):
        return flagship.setup_file(flagship.SETUPS_DIR / "spreading_ring.yml",
                                   16, 32, MonitorTimestep="0.05",
                                   Nsnapshots="1", DistributedOutput=flag)

    js = JSimulation(JConfig.from_dict(cfg("yes")))
    jout.OutputWriter(js, tmp_path / "jax")
    cap = _Capture()
    js.monitor_hooks.insert(0, cap)
    js.run()
    assert [r["n_monitor"] for r in cap.records] == [0, 1]

    dirs = {}
    for flag in ("yes", "no"):
        # the port's own run
        ts = Simulation(Config.from_dict(cfg(flag)), device="cpu")
        w = tout.OutputWriter(ts, tmp_path / f"run_{flag}")
        ts.run()
        w.close()
        dirs[f"run_{flag}"] = tmp_path / f"run_{flag}"
        # the JAX run's states through the port's writer
        ts = Simulation(Config.from_dict(cfg(flag)), device="cpu")
        w = tout.OutputWriter(ts, tmp_path / f"carry_{flag}")
        for rec in cap.records:
            tree = system_state_to_numpy(ts.state)
            tree.update(rec["tree"])
            ts.state = system_state_from_numpy(tree, "cpu", ts.dtype)
            ts.time = torch.tensor(rec["time"], dtype=ts.dtype)
            ts.last_dt = torch.tensor(rec["last_dt"], dtype=ts.dtype)
            ts.n_monitor = rec["n_monitor"]
            ts.n_hydro_iter = rec["n_hydro_iter"]
            ts.monitor_stats = rec["monitor_stats"]
            ts._handle_outputs()
        w.close()
        dirs[f"carry_{flag}"] = tmp_path / f"carry_{flag}"

    for sid in ("0", "1"):
        names = sorted(p.name for p in (dirs["run_no"] / "snapshots"
                                        / sid).iterdir()
                       if p.suffix in (".dat", ".bin"))
        assert "Sigma.dat" in names and not any(".r0" in n for n in names)
        for name in names:
            ref = (dirs["run_no"] / "snapshots" / sid / name).read_bytes()
            assert (dirs["run_yes"] / "snapshots" / sid
                    / name).read_bytes() == ref, (sid, name)
            carried = (dirs["carry_no"] / "snapshots" / sid
                       / name).read_bytes()
            assert (dirs["carry_yes"] / "snapshots" / sid
                    / name).read_bytes() == carried, (sid, name)
        for name in ("Sigma.dat", "vrad.dat", "vazi.dat", "energy.dat",
                     "misc.bin", "nbody.bin"):
            assert (tmp_path / "jax" / "snapshots" / sid
                    / name).read_bytes() == (dirs["carry_yes"] / "snapshots"
                                             / sid / name).read_bytes(), \
                (sid, name)

"""The PDS70 gas slice end to end: fargocpt_torch's Simulation of
``flagship.pds70_gas`` (PVTE, FLD, symmetric FFT self-gravity, surface
cooling, SN artificial viscosity, FARGO transport, one star) against the
JAX package's, both on the CPU, in float64 (float32 and the PVTE refresh
count: tests/test_torch_pds70_f32.py).

Tolerances. float64 at 32x64: sigma, vaz, energy and the Q grids to rtol
1e-10 after 10 steps. v_rad is held to atol 1e-9 * max|v_rad|: its initial
steady viscous drift is a finite difference of pow()-based profiles that
numpy and XLA round differently (see tests/test_torch_slice.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.ops import pallas_kernels as pk
from fargocpt_tpu.params import physics_from_config as j_physics_from_config
from fargocpt_tpu.sim import Simulation as JSimulation
from fargocpt_tpu.step import HydroStep as JHydroStep
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.config import Config
from fargocpt_torch.flagship import FLAGSHIP, PDS70_GAS, pds70_gas
from fargocpt_torch.params import physics_from_config
from fargocpt_torch.sim import Simulation, reachable_tensors
from fargocpt_torch.state import (state_keys, system_state_from_numpy,
                                  system_state_to_numpy)
from fargocpt_torch.step import gates
from fargocpt_torch.units import Units

torch.set_num_threads(2)

FIELDS = ("sigma", "vrad", "vaz", "energy")


def _cfg(nr, naz, **kw):
    return dict(PDS70_GAS, Nrad=str(nr), Naz=str(naz), **kw)


def jax_state_tree(state) -> dict[str, np.ndarray]:
    """The JAX SystemState as the port's flat dotted-name dict, with its
    optional parts keyed by position."""
    tree = {}
    for key in state_keys():
        obj = state
        for part in key.split("."):
            obj = getattr(obj, part)
        tree[key] = np.asarray(obj)
    for name in ("pvte_guess", "sg_kernel"):
        value = getattr(state, name)
        if value is not None:
            tree.update({f"{name}.{k}": np.asarray(v)
                         for k, v in enumerate(value)})
    if state.fld_sor is not None:
        tree["fld_sor"] = np.asarray(state.fld_sor)
    return tree


@pytest.fixture(scope="module")
def pair64():
    return (JSimulation(JConfig.from_dict(_cfg(32, 64))),
            Simulation(pds70_gas(32, 64), device="cpu"))


def test_physics_equals_jax_pds70():
    """pds70_gas is __graft_entry__._pds70 without the dust."""
    import __graft_entry__
    import fargocpt_tpu.sim as jsim
    captured = {}
    real = jsim.Simulation
    jsim.Simulation = lambda cfg, dtype: captured.setdefault("cfg", cfg)
    try:
        __graft_entry__._pds70(32, 64, "float64")
    finally:
        jsim.Simulation = real
    jp = j_physics_from_config(captured["cfg"], JUnits(), dtype="float64")
    tp = physics_from_config(pds70_gas(32, 64), Units(), dtype="float64")
    differ = {f.name for f in dataclasses.fields(jp)
              if getattr(jp, f.name) != getattr(tp, f.name)}
    assert differ == {"integrate_particles"}
    assert jp.integrate_particles and not tp.integrate_particles


@pytest.mark.parametrize("setup", [FLAGSHIP, PDS70_GAS],
                         ids=["flagship", "pds70_gas"])
def test_gates_match_jax(setup, monkeypatch):
    """The port's fused-op decisions are the JAX package's where its
    TPU-only terms hold (float32 on a TPU, NAZ % 128 == 0, NR a multiple
    of the viscous-kick tile)."""
    cfg = dict(setup, Nrad="32", Naz="128")
    sim = Simulation(Config.from_dict(dict(cfg)), dtype="float32",
                     device="cpu")
    monkeypatch.setattr(pk, "use_pallas", lambda dtype=None: True)
    units = JUnits()
    jcfg = JConfig.from_dict(dict(cfg))
    jcfg.set_units(units)
    jphys = j_physics_from_config(jcfg, units, dtype="float32")
    js = JHydroStep(jphys, sim.constants, sim.geometry, None, units=units)
    got = gates(sim.phys)
    assert got == sim.stepper.gates
    assert (got["sources"], got["viscous_kick"], got["cfl"]) == \
        (js._fuse_sources, js._fuse_visc, js._fuse_cfl)
    # the JAX package runs the SN substep of its unfused branch as jnp;
    # the port runs it as the artvisc_sn kernel
    assert got["artvisc_sn"] == (not js._fuse_visc)
    assert got["viscous_kick"] == (setup is FLAGSHIP)


def _assert_fields(t_state, j_state, rtol=1e-10, vrad_atol=1e-9):
    for name in FIELDS:
        ref = np.asarray(getattr(j_state.fields, name))
        atol = vrad_atol * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(t_state.fields, name).numpy(),
                                   ref, rtol=rtol, atol=atol, err_msg=name)
    for name in ("qplus", "qminus"):
        ref = np.asarray(getattr(j_state, name))
        np.testing.assert_allclose(getattr(t_state, name).numpy(), ref,
                                   rtol=rtol, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)


def test_initial_state_equals_jax(pair64):
    js, ts = pair64
    j, t = jax_state_tree(js.state), system_state_to_numpy(ts.state)
    assert set(t) == set(j)
    assert {"sg_kernel.0", "sg_kernel.3"} <= set(t)
    for key in j:
        rtol = 1e-9 if key == "fields.vrad" else 1e-12
        atol = 1e-12 * np.abs(j[key]).max() if key.startswith("sg_") else 0.0
        np.testing.assert_allclose(t[key], j[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def test_ten_steps_match_jax_f64(pair64):
    js = JSimulation(JConfig.from_dict(_cfg(32, 64)))
    ts = Simulation(pds70_gas(32, 64), device="cpu")
    for _ in range(10):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)
    _assert_fields(ts.state, js.state)
    # the boundary mass flux is a product with v_rad (atol 1e-9 above)
    np.testing.assert_allclose(
        ts.state.monitor_acc.mass_delta.numpy(),
        np.asarray(js.state.monitor_acc.mass_delta), rtol=1e-9, atol=1e-30)
    assert ts.state.sg_kernel[3] == int(js.state.sg_kernel[3])
    np.testing.assert_allclose(float(ts.state.sg_kernel[2]),
                               float(js.state.sg_kernel[2]), rtol=1e-12)
    # seeded from the JAX state, the port steps on with it
    ts.state = system_state_from_numpy(jax_state_tree(js.state), "cpu",
                                       torch.float64)
    dj = js.calculate_time_step()
    js.step_once(dj)
    ts.step_once(torch.tensor(dj, dtype=torch.float64))
    _assert_fields(ts.state, js.state)


def test_run_lands_on_the_monitor_boundary():
    cfg = _cfg(32, 64, MonitorTimestep="0.02")
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    js.run()
    ts.run()
    assert ts.n_hydro_iter == js.n_hydro_iter > 3
    assert float(ts.time) == pytest.approx(js.time, rel=1e-14)
    assert float(ts.time) == pytest.approx(js.settings.monitor_timestep,
                                           rel=1e-14)
    _assert_fields(ts.state, js.state)


def test_every_tensor_lives_on_the_run_device(pair64):
    _, ts = pair64
    found = dict(reachable_tensors(ts))
    for path in ("sim.stepper.pvte.tabs[2]", "sim.stepper.fld.red",
                 "sim.stepper.selfgravity.U",
                 "sim.state.sg_kernel[0]"):
        assert path in found, path
    assert {t.device.type for t in found.values()} == {"cpu"}


@pytest.mark.parametrize("extra", [
    {"SurfaceCooling": "thermal"},
    {"SelfGravity": "Yes", "SelfGravityMode": "symmetric"},
    {"RadiativeDiffusion": "Yes", "RadiativeDiffusionTolerance": "1e-5"},
], ids=["surface_cooling", "self_gravity", "fld"])
def test_flagship_with_one_pds70_feature(extra):
    """Constant gamma with one of the slice's features: the fused kernels
    where the gates allow them (plain versions on the CPU) beside the
    unfused substeps, self-gravity or FLD; 4 steps against JAX at 16x32."""
    cfg = dict(FLAGSHIP, Nrad="16", Naz="32", **extra)
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert ts.stepper.gates["viscous_kick"] == ("SurfaceCooling" not in extra)
    for _ in range(4):
        dj = js.calculate_time_step()
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float64))
    _assert_fields(ts.state, js.state)


@pytest.mark.parametrize("extra,feature", [
    ({"IntegrateParticles": "yes", "ParticleDustDiffusion": "yes"}, "dust"),
    ({"SelfGravityMode": "besselkernel"}, "Bessel"),
    ({"PVTELookupTable": "yes"}, "PVTELookupTable"),
])
def test_unported_features_raise(extra, feature):
    with pytest.raises(NotImplementedError, match=feature):
        Simulation(Config.from_dict(_cfg(16, 32, **extra)), device="cpu")

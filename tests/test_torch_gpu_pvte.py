"""The float64 PVTE refresh kernel (``csrc/pvte_refresh.cu``,
``kernels.pvte_refresh``) against its plain version
(``kernels.pvte_refresh_plain``, the pipeline of ``ops/pvte.py``) on the
same GPU tensors.

Inputs: the seeded (rho, e) of tests/test_torch_pvte.py, which span the
molecular, dissociating and ionised gas, and edge cases: e = 0 and e at
float64's smallest normal (T at the bracket's lower end, 1 K), e far
above the bracket's top (T at 1e7 K), a density sweep that carries the
Saha arguments of x and y across their 1e8 saturation, the shock-tube
form, cell counts that are no multiple of the kernel's block of 128, and
the 1000x2 and 450x1070 grids of the PVTE shock tube and V1504 Cyg.

Tolerances: those of tests/test_torch_pvte.py, gamma_eff and mu rtol
1e-13, gamma1 rtol 1e-10 (its finite differences with eps = 1e-4 scale
the rounding by 1e4), atol 0.

A float64 PVTE step launches the kernel once for each PVTE refresh
(``launch.pvte_refresh`` equals ``pvte.refresh``); a float32 step and a
lookup-table step launch none.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. This file imports no JAX:

    python -m pytest tests/test_torch_gpu_pvte.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from fargocpt_torch import telemetry
from fargocpt_torch.flagship import pds70_gas, shocktube_pvte
from fargocpt_torch.ops import kernels, pvte
from fargocpt_torch.params import Physics
from fargocpt_torch.sim import Simulation
from fargocpt_torch.units import Units

torch.set_num_threads(2)

N = 3000
RTOL = {"gamma_eff": 1e-13, "mu": 1e-13, "gamma1": 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _evaluator(device, shock_tube=0):
    phys = Physics(variable_gamma=True, shock_tube=shock_tube)
    return pvte.PVTE(phys, Units(), torch.float64, device)


def _planes(pv, rho, e, device, seed=9):
    """(sigma, energy, H) in code units whose cgs density and specific
    energy are ``rho`` and ``e`` (to rounding), H seeded."""
    c = kernels.pvte_constants(pv)
    rho, e = np.asarray(rho, np.float64), np.asarray(e, np.float64)
    h = np.random.default_rng(seed).uniform(0.01, 0.1, rho.shape)
    sigma = rho / c["to_density"]
    if pv.shock_tube == 0:
        sigma = sigma * c["density_factor"] * h
    energy = e / c["to_e_spec"] * sigma
    return [torch.tensor(a, dtype=torch.float64, device=device)
            for a in (sigma, energy, h)]


def _held(pv, sigma, energy, h):
    """The kernel's three planes against the plain version's at RTOL; the
    plain version's planes."""
    got = kernels.pvte_refresh(pv, sigma, energy, h)
    ref = kernels.pvte_refresh_plain(pv, sigma, energy, h)
    for name, a, b in zip(RTOL, got, ref):
        assert a.shape == sigma.shape and a.dtype == torch.float64
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=RTOL[name], atol=0.0, err_msg=name)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("shock_tube", [0, 2])
def test_pvte_refresh_kernel_matches_plain_on_the_seeded_gas(cuda,
                                                             shock_tube):
    rng = np.random.default_rng(3)
    rho = 10.0 ** rng.uniform(-13, -5, N)
    e = 10.0 ** rng.uniform(9, 14, N)
    pv = _evaluator(cuda, shock_tube)
    before = telemetry.value("launch.pvte_refresh")
    _held(pv, *_planes(pv, rho, e, cuda))
    assert telemetry.value("launch.pvte_refresh") == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shock_tube", [0, 2])
def test_pvte_refresh_kernel_at_the_edges(cuda, shock_tube):
    """e = 0, float64's smallest normal and 1e20 erg/g (T at 1 K and at
    1e7 K, the bracket's ends); rho from 1e-25 to 1e-2 at e from 1e11 to
    1e15, which puts the Saha argument of x and of y at the solved T on
    both sides of 1e8."""
    tiny = torch.finfo(torch.float64).tiny
    rho_sweep = np.logspace(-25, -2, 240)
    e_sweep = np.repeat([1e11, 1e12, 1e13, 1e14, 1e15], 48)
    rho = np.concatenate([[1e-9, 1e-9, 1e-9, 1e-20, 1e-2], rho_sweep])
    e = np.concatenate([[0.0, tiny, 1e20, 1e20, tiny], e_sweep])
    pv = _evaluator(cuda, shock_tube)
    sigma, energy, h = _planes(pv, rho, e, cuda)
    ref = _held(pv, sigma, energy, h)
    rho_cgs, e_cgs = pv.cgs(sigma, energy, h)
    T = pvte.temperature_from_energy(e_cgs, rho_cgs, pv.x_mf, pv.tabs)
    assert float(T[:2].max()) < 1.0 + 1e-12
    assert float(T[2:4].min()) > 1e7 * (1.0 - 1e-12)
    c = kernels.pvte_constants(pv)
    t15 = T ** 1.5
    for k, ex in (("cx", "ex"), ("cy", "ey")):
        a = c[k] * t15 * torch.exp(c[ex] / (c["kb"] * T)) / rho_cgs
        assert bool((a >= 1e8).any()) and bool((a < 1e8).any()), k
    assert all(bool(torch.isfinite(r).all()) for r in ref)


def _device_activity(fn, calls=5):
    """What ``calls`` calls of ``fn`` asked of the device (every launch,
    copy and fill the host requested) and the names of the device kernels
    that ran (the profiler now and then drops one of these)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    asked = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and ("LaunchKernel" in e.name or "Memcpy" in e.name
                  or "Memset" in e.name)]
    # the device-side annotations of the port's spans (``fc:``) are not
    # work the call asked of the device
    ran = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("fc:")]
    return asked, ran


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (127,), (129,), (1000, 2),
                                   (450, 1070)])
def test_pvte_refresh_kernel_on_grids(cuda, shape):
    """Code-unit grids as tests/test_torch_pvte.py's PVTE class test draws
    them, at cell counts on and off the block of 128 and at the PVTE shock
    tube's and V1504 Cyg's grids; a call asks the device for one launch
    and nothing else."""
    rng = np.random.default_rng(sum(shape))
    sigma = rng.uniform(1e-5, 1e-3, shape)
    energy = sigma * rng.uniform(1e-6, 1e-2, shape)
    h = rng.uniform(0.01, 0.1, shape)
    args = [torch.tensor(a, dtype=torch.float64, device=cuda)
            for a in (sigma, energy, h)]
    pv = _evaluator(cuda)
    _held(pv, *args)
    calls = 5
    asked, ran = _device_activity(lambda: kernels.pvte_refresh(pv, *args),
                                  calls)
    assert len(asked) == calls and all("LaunchKernel" in n for n in asked), \
        asked
    assert 1 <= len(ran) <= calls and all("pvte_refresh_kernel" in n
                                          for n in ran), ran


@pytest.mark.gpu
def test_pvte_refresh_refuses_what_it_cannot_take(cuda):
    pv = _evaluator(cuda)
    s = torch.ones((4, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        kernels.pvte_refresh(pv, s.float(), s.float(), s.float())
    with pytest.raises(ValueError, match="shape"):
        kernels.pvte_refresh(pv, s, s, s[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.pvte_refresh(pv, s.t(), s.t(), s.t())


def _step(sim, steps):
    """``steps`` steps (calculate_time_step + step_once); the PVTE
    refreshes and the pvte_refresh launches they made."""
    r0 = telemetry.value("pvte.refresh")
    l0 = telemetry.value("launch.pvte_refresh")
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    return (telemetry.value("pvte.refresh") - r0,
            telemetry.value("launch.pvte_refresh") - l0)


@pytest.mark.gpu
def test_float64_pvte_step_serves_every_refresh_with_the_kernel(cuda):
    """The PDS70 gas setup at 32x64 float64: three refreshes a step, each
    one launch of the kernel (its share of the refreshes is 1); three
    steps on the card's dt agree with the CPU at 1e-9 of each field's
    scale."""
    gpu = Simulation(pds70_gas(32, 64), dtype="float64", device=cuda)
    cpu = Simulation(pds70_gas(32, 64), dtype="float64", device="cpu")
    dts = []
    r0 = telemetry.value("pvte.refresh")
    l0 = telemetry.value("launch.pvte_refresh")
    for _ in range(3):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        dts.append(dt.cpu())
    torch.cuda.synchronize()
    refreshes = telemetry.value("pvte.refresh") - r0
    assert refreshes == 9
    assert telemetry.value("launch.pvte_refresh") - l0 == refreshes
    for dt in dts:
        cpu.calculate_time_step()
        cpu.step_once(dt)
    for name in ("sigma", "vrad", "vaz", "energy"):
        a, b = getattr(gpu.fields, name).cpu(), getattr(cpu.fields, name)
        scale = float((cpu.fields.vaz if name == "vrad" else b).abs().max())
        assert float((a - b).abs().max()) <= 1e-9 * scale, name


@pytest.mark.gpu
def test_float32_and_lookup_steps_launch_no_refresh_kernel(cuda):
    """The float32 PDS70 gas step (the warm Newton path) and the PVTE shock
    tube on lookup tables refresh PVTE and never launch the kernel."""
    sim = Simulation(pds70_gas(32, 64), dtype="float32", device=cuda)
    refreshes, launches = _step(sim, 2)
    assert refreshes > 0 and launches == 0
    sim = Simulation(shocktube_pvte(lookup=True), device=cuda)
    refreshes, launches = _step(sim, 2)
    assert refreshes > 0 and launches == 0

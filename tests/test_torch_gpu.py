"""The CUDA kernels of fargocpt_torch against their plain PyTorch versions
on the same GPU tensors, at a ragged 130x200 float64 grid, with the
tolerances of tests/test_torch_kernels.py (rtol 1e-12 cfl, 1e-11 sources
and transport, 1e-10 viscous kick).

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. This file imports no JAX, so it runs on a GPU host that has none:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import gravity, kernels, transport
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 130, 200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _ctx(kw, device, nr=NR, naz=NAZ):
    geom = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    return kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                 geom, torch.float64, device)


def _fields(seed, device, nr=NR, naz=NAZ, dtype=torch.float64,
            floor_cells=False):
    rng = np.random.default_rng(seed)
    sigma = rng.random((nr, naz)) + 0.5
    if floor_cells:
        sigma[nr // 3, 3:7] = 5e-6
    f = dict(sigma=sigma,
             energy=rng.random((nr, naz)) * 1e-3 + 1e-3,
             vaz=(rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
             vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.05,
             qplus=rng.random((nr, naz)) * 1e-6,
             qminus=rng.random((nr, naz)) * 1e-6)
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in f.items()}


def _one(v, device):
    return torch.tensor(v, dtype=torch.float64, device=device)


def _close(got, ref, rtol, atols):
    for g, r, atol in zip(got, ref, atols):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("adiabatic,sn", [(True, True), (False, False)])
def test_cfl_kernel_matches_plain(cuda, adiabatic, sn):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, viscous_alpha=1e-3,
                    aspectratio_ref=0.05,
                    artificial_viscosity="sn" if sn else "tw"), cuda)
    f = _fields(2, cuda)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], f["qplus"],
            f["qminus"])
    before = kernels.LAUNCHES["cfl"]
    got = kernels.cfl(ctx, *args)
    assert kernels.LAUNCHES["cfl"] == before + 1
    np.testing.assert_allclose(float(got),
                               float(kernels.cfl_plain(ctx, *args)),
                               rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("adiabatic", [True, False])
def test_sources_kernel_matches_plain(cuda, adiabatic):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, thickness_smoothing=0.6,
                    aspectratio_ref=0.05, imposed_disk_drift=1e-4), cuda)
    f = _fields(5, cuda)
    bodies = gravity.BodiesOnGrid(
        x=_one([0.0, 1.0], cuda), y=_one([0.0, 0.3], cuda),
        mass=_one([1.0, 1e-3], cuda),
        cubic_smoothing_radius=_one([0.0, 0.05], cuda))
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], bodies,
            (_one(1e-5, cuda), _one(-2e-5, cuda)), _one(0.4, cuda),
            _one(0.003, cuda))
    _close(kernels.sources(ctx, *args), kernels.sources_plain(ctx, *args),
           1e-11, (1e-13, 1e-13))


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("artvisc_on", ["sn", "tw", "none"])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_viscous_kick_kernel_matches_plain(cuda, compress, artvisc_on,
                                           adiabatic):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, viscous_alpha=1e-3,
                    aspectratio_ref=0.05, flaring_index=0.25,
                    artificial_viscosity=artvisc_on,
                    artificial_viscosity_dissipation=True,
                    heating_viscous=True, cooling_beta_enabled=True,
                    cooling_beta=10.0, minimum_temperature=1e-6, sigma0=1.0,
                    sigma_floor=1e-6), cuda)
    f = _fields(11, cuda, floor_cells=True)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], _one(0.003, cuda),
            0.0)
    _close(kernels.viscous_kick(ctx, *args, compress=compress),
           kernels.viscous_kick_plain(ctx, *args, compress=compress),
           1e-10, (1e-13, 1e-13, 1e-16, 1e-18, 1e-18))


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_transport_kernel_matches_plain(cuda, adiabatic, fast):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, aspectratio_ref=0.05,
                    fast_transport=fast), cuda)
    f = _fields(13, cuda)
    dt, omega = _one(0.01, cuda), _one(0.3, cuda)
    shift = transport.fargo_shift(ctx.g, f["vaz"], dt)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], omega, dt, shift)
    _close(kernels.transport(ctx, *args), kernels.transport_plain(ctx, *args),
           1e-11, (1e-14, 1e-13, 1e-13, 1e-14, 1e-15))


@pytest.mark.gpu
def test_kernel_refuses_a_dtype_other_than_its_context(cuda):
    ctx = _ctx(dict(eos="adiabatic", artificial_viscosity="sn"), cuda, 16, 32)
    f = _fields(2, cuda, 16, 32, dtype=torch.float32)
    with pytest.raises(TypeError):
        kernels.cfl(ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
                    f["qplus"], f["qminus"])


@pytest.mark.gpu
def test_kernel_refuses_non_contiguous_fields(cuda):
    ctx = _ctx(dict(eos="adiabatic", artificial_viscosity="sn"), cuda, 16, 32)
    f = _fields(2, cuda, 16, 64)
    half = {k: v[:, ::2] for k, v in f.items()}
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cfl(ctx, half["sigma"], half["vrad"], half["vaz"],
                    half["energy"], half["qplus"], half["qminus"])

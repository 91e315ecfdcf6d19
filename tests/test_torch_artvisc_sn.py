"""The Stone-Norman artificial viscosity op of fargocpt_torch
(``kernels.artvisc_sn``, a CUDA kernel on the GPU) on the CPU, where it
takes its plain version: held to the TPU kernel it replaces,
``pallas_kernels.artvisc_sn_pallas`` run in Pallas interpret mode (as
tests/test_pallas_kernels.py runs it), and to the JAX package's
``artvisc.update_sn``, in float64 with dissipation on and off. Tolerance
rtol 1e-12 (plus 1e-15 absolute on v_rad and v_az, which cross zero)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import artvisc as j_artvisc
from fargocpt_tpu.ops import pallas_kernels as pk
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics

from fargocpt_torch import telemetry
from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import kernels
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 64, 256          # NAZ a multiple of the TPU kernel's 128 lanes


def _inputs():
    rng = np.random.default_rng(9)
    return (rng.random((NR, NAZ)) + 0.5,
            (rng.random((NR + 1, NAZ)) - 0.5) * 0.3,
            (rng.random((NR, NAZ)) - 0.5) * 0.3,
            rng.random((NR, NAZ)) + 0.2)


@pytest.mark.parametrize("dissipation", [True, False])
def test_artvisc_sn_plain_matches_the_tpu_kernel(dissipation):
    kw = dict(eos="adiabatic", artificial_viscosity="sn",
              artificial_viscosity_dissipation=dissipation)
    geom = Geometry.build(NR, NAZ, 0.4, 2.5, "Log")
    ctx = kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                geom, torch.float64, "cpu")
    jphys = JPhysics(**kw)
    jg = j_prepare_geom(JGeometry.build(NR, NAZ, 0.4, 2.5, "Log"),
                        jnp.float64)
    sigma, vrad, vaz, energy = _inputs()
    dt = 0.01
    telemetry.reset("launch.")
    got = kernels.artvisc_sn(ctx, *(torch.tensor(a) for a in
                                    (sigma, vrad, vaz, energy)),
                             torch.tensor(dt, dtype=torch.float64))
    assert telemetry.value("launch.artvisc_sn") == 0    # the plain version ran
    j_args = [jnp.asarray(a) for a in (sigma, vrad, vaz, energy)]
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = pk.artvisc_sn_pallas(
            *j_args, pk.make_artvisc_cols(jg, jnp.float64), jnp.float64(dt),
            c2=jphys.artificial_viscosity_factor ** 2,
            dissipation=dissipation, invdphi=jg.invdphi)
    ref_jnp = j_artvisc.update_sn(jphys, jg, *j_args, jnp.float64(dt))
    for ref in (ref_pallas, ref_jnp):
        for name, a, b in zip(("vrad", "vaz", "energy"), got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-15, err_msg=name)
    changed = [not np.array_equal(a.numpy(), x)
               for a, x in zip(got, (vrad, vaz, energy))]
    assert changed == [True, True, dissipation]

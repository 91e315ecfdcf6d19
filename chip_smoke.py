"""Runs fargocpt_torch's main paths on one CUDA GPU and checks them.

    python3 chip_smoke.py

Four setups (fargocpt_torch/flagship.py). The flagship (constant gamma)
takes the fused kernels: cfl, sources, viscous_kick, and the transport by
one of three routes: the whole-transport kernel on every grid
(fargocpt_torch/ops/transport.route; 1024x3072 and 1000x3072 here) or,
where the caller names it, the split route's two kernels,
radial_momenta_sweep and fargo_theta (transport_route="split",
1000x3072), or the staged route's three: radial_sweep, theta_sweep once
per azimuthal pass, advect_shift (transport_route="staged", 1024x3072).
The PDS70 gas setup (PVTE, FLD, FFT self-gravity, surface
cooling) takes the unfused substeps with the artvisc_sn kernel and the
whole-transport kernel (1024x3072); the whole PDS70 setup adds its
Lagrangian dust, 16384 particles. The planet_disk (examples/quickstart.yml's
physics: a locally isothermal disk with damping zones and a star and a
ramped Jupiter with disk feedback) takes cfl, sources, viscous_kick and the
whole-transport kernel in their isothermal variants, and the ias15 kernel
twice a step (the N-body integrator: the indirect term's predictor and the
drift). The planet_torque (the reference's type-I torque test: the
leapfrog integrator, a locally isothermal disk, a ramped 2e-5 planet)
takes cfl and the whole-transport kernel once a step, sources and
viscous_kick twice (the leapfrog's two kicks) and ias15 four times (two
half drifts, two predictors). The planet_accretion (the reference's
accretion test: the planet_torque's disk in the corotating frame, its
planet accreting by Kley's scheme with disk feedback, the MassFlow and
gas-torque monitor grids on) takes the same kernels but the sources: an
accreting step's first kick reads the pressure from before the accretion,
which the unfused substep takes. The binary_gcfull
(setups/gamma_cephei_full.yml's physics: a circumprimary disk in the
eccentric gamma Cephei binary, N-body-centred initial conditions with the
circumbinary ring, AspectRatioMode 1, AlphaMode 2, StabilizeViscosity 1,
irradiation from both stars, the center-of-mass outer boundary, the
leapfrog, the secondary accreting) takes the whole-transport kernel once a
step and ias15 four times: the gates keep cfl, sources and viscous_kick
off there, as the JAX package's do. The cataclysmic variables, in float64
(their float32 Q+ / Q- are NaN from the start in both packages): OY_Car
(setups/CloseBinaries/OY_Car.yml: an ideal gas with thermal surface
cooling fed by the Roche-lobe stream, the Euler step in the corotating
frame) takes cfl, sources, artvisc_sn (the viscous kick's gate is off
under surface cooling) and the whole-transport kernel once a step and
ias15 twice; V1504 Cyg (setups/V1504Cyg.yml: PVTE, S-curve cooling,
AspectRatioMode 1, AlphaMode 1, the stream, the leapfrog) the transport
once and ias15 four times. The long tail: the planet_disk_sg
(examples/quickstart.yml with SelfGravity: Yes, the default Bessel
kernel, whose mode keeps cfl, sources and viscous_kick off) takes
artvisc_sn and the whole-transport kernel once a step and ias15 twice;
examples/full_physics.yml (symmetric self-gravity, FLD, surface cooling,
irradiation, 2000 diffusing particles; float64, since in float32 its
swarm dies on the first step in both packages) cfl, sources, artvisc_sn
and the transport once. All thirteen paths are driven here,
setups/star_planet.yml (Euler, corotating), the polytropic EoS, Disk: no
and the long tail's initial conditions in phase 4.

Phases (any failure raises, so the exit code is not 0):
  1. environment: GPU name and power limit, torch/CUDA versions, nvcc,
     and the build of the CUDA kernels from fargocpt_torch/csrc;
  2. per-kernel parity: each of the thirteen kernels (kernels.OPS) against its
     plain PyTorch version on the same GPU tensors, at full size in
     float32 (a setup's state with seeded noise: the flagship at 1024x3072
     for the whole route's four kernels and the staged route's three, at
     1000x3072 for the split route's two, the PDS70 gas state at 1024x3072
     for artvisc_sn, whose outputs are measured against the plain
     version's increments; the roll of advect_shift bit for bit; the PDS70
     gas state in float64 at 1024x3072 for pvte_refresh, PVTE_RTOL) and at
     130x200 float64 (seeded random fields), plus each one's time beside
     the plain version's (CUDA events, median of 25 calls), its least time
     on the card: the bytes of its inputs and outputs at the memory rate
     against the floating-point operations of its plain version (counted
     by FlopCounter) at the float32 rate, and for advect_shift the time of
     the one PyTorch call that computes it (torch.gather with a prebuilt
     index); the whole-transport kernel, viscous_kick, sources, cfl,
     advect_shift, theta_sweep, fargo_theta, radial_momenta_sweep and
     radial_sweep launch by launch
     (torch.profiler: each launch's device time, the bytes it must move and
     the memory rate that makes, the wrapper's share of the event time and
     the device launches it adds); the whole-transport kernel at two more
     shapes that cross the edges of its tiles (37x1030 and 20x7, float64
     and float32), viscous_kick and sources at shapes that cross every edge
     of theirs (KICK_SHAPES, both dtypes, SN and TW, both EoS, three
     bodies), cfl, theta_sweep and fargo_theta at shapes that cross every
     edge of their ring blocks and tiles (CFL_SHAPES, THETA_SHAPES: NR = 3,
     rings of 1 and 7 cells, both dtypes, K = 1, 2, 5, 6, cfl with planted
     NaN and zero-energy cells), radial_momenta_sweep and radial_sweep at
     shapes that cross every edge of the radial column march's strips and
     blocks (RADIAL_SHAPES: NR = 3 to 33, NAZ = 1 to 129 and 37x1030, both
     dtypes, both EoS and K = 1, 2, 5, 6, both limiters); the split route as
     a whole against the whole-transport kernel on the same 1000x3072
     state, and the three routes on one 1024x3072 state in turns; the
     isothermal variants of cfl, sources (a star and a 1e-3 planet at
     r = 1 half way up its mass ramp), viscous_kick and the transport
     (K = 5) at 1024x3072 float32 on the perturbed planet_disk state; ias15
     against its plain version on the card in float64 (two bodies at
     e = 0.9 and four bodies over a period, and the planet_disk's bodies
     and step: the same substeps, the state to 1e-13), each one's ms a
     call by events and the plain version's device launches; the four
     kernels at the goldens' grids (97x376, 256x2, 100x2), both dtypes,
     isothermal, SN and TW; the leapfrog's kernel interfaces at 1024x3072
     float32 on the perturbed flagship state: sources with a smoothing
     plane h_smooth and viscous_kick with its in-kick sound speed, each
     timed with its bound counting the extra plane; sources with 513
     bodies (two chunks of its per-body table) in both dtypes, and ias15
     with 17 and 40 bodies (its device workspace) bit for bit with the
     same counts, its ms a call at 17;
  3. the slices: the flagship Simulation on the GPU at 1024x3072 on the
     whole and on the staged route and at 1000x3072 on the split route
     (named) and on the route the grid takes by itself (the whole one),
     float32 (10 warm-up and 60 timed steps each of calculate_time_step +
     step_once; 30 at 1000x3072 whole), the 1000x3072 step through the split and whole routes in
     turns and the 1024x3072 step through all three in turns, then the
     PDS70 gas Simulation and the whole PDS70 Simulation with its 16384
     particles at 1024x3072 float32 (3 warm-up and 10 timed steps, then
     the run path's advance_to over about 10 steps), each with the launch
     counters set to 0 before and read after; the planet_disk at 1024x3072
     float32 (10 warm-up and 60 timed steps; cfl, sources, viscous_kick
     and the transport once a step, ias15 twice, no other kernel), with
     its device launches, PyTorch launches, device time and busy share a
     step from torch.profiler and its host reads a step from CUDA's sync
     debug mode; the planet_torque at 1024x3072 float32 the same way (cfl
     and the transport once a step, sources and viscous_kick twice, ias15
     four times); the planet_accretion at 1024x3072 float32 the same way
     (cfl, sources and the transport once a step, viscous_kick twice,
     ias15 four times), then its first kick's unfused sources substep
     against the sources kernel on the same state (ms a call, device
     launches); setups/gamma_cephei_full.yml (flagship.binary_gcfull, its
     MassFlow grid on) at its own 1609x1160 float32 (10 warm-up and 30
     timed steps: the transport once a step, ias15 four times, no other
     kernel, 0 host reads), then the whole-transport kernel against its
     plain version on its state and dt at that shape (1609 rings cut the
     last 16-row strip, 1160 cells the last 512-cell block), each output
     within F32_TOL of its scale; OY_Car at its own 200x200 float64 (10
     warm-up and 60 timed steps: cfl, sources, artvisc_sn, the transport
     once a step, ias15 twice, no other kernel, 0 host reads), then those
     four kernels against their plain versions on its state and dt (rtol
     F64_RTOL, atol 1e-13 of the scale; each one's ms, plain ms and bound
     at the float64 rate), and V1504 Cyg at its own 450x1070 float64 (5
     warm-up and 20 timed steps: the transport once, ias15 four times, 0
     host reads), then the transport against its plain version there;
     the planet_disk_sg at 1024x3072 float32 (10 warm-up and 60 timed
     steps: artvisc_sn and the transport once a step, ias15 twice, no
     other kernel, 0 host reads), then the whole-transport kernel against
     its plain version on its state; examples/full_physics.yml at its own
     128x256 float64 (artvisc_sn, cfl, sources, the transport once a
     step), then those four kernels against their plain versions on its
     state as OY_Car's are held, with the swarm's alive count and the
     spread of its radii;
     the PDS70 lines add the FLD
     SOR iterations and the PVTE refreshes per step (3 and, on the run
     path, 2, with or without the dust), and with the dust its share of
     the step by CUDA events and the particles alive;
  4. the trajectories against the CPU: the flagship, whole route, 256x512
     float32 for 200 steps (rel-L2 < 1e-3 per field) and 128x256 float64
     for 20 steps (rel-L2 < 1e-9); split route 250x512 float32 for 200
     steps and 130x256 float64 for 20 steps, staged route 256x512 and
     128x256, the same budgets; the PDS70 gas setup and the whole PDS70
     setup (4096 particles) at 64x128, float32 for 100 steps and float64
     for 20, the same budgets, the swarm's r and phi held to them too. The
     GPU run goes through the kernels and the CPU run through the plain
     versions, both on the GPU run's dt sequence. Then the PDS70 gas setup
     at 128x384 float32 for 200 steps on the GPU with one warm PVTE Newton
     step against three (rel-L2 < 1e-4, the budget of a warm against a
     cold PVTE refresh); the planet_disk at 256x512 float32 for 200 steps
     and 128x256 float64 for 20, the same budgets, the bodies' state held
     to them too; the planet_torque at 256x512 float32 for 200 steps and
     128x256 float64 for 20, the binary_gceph golden's physics (two stars,
     the leapfrog, ideal gas with thermal cooling: the unfused substeps
     and the sources' smoothing plane) and the quickstart disk with an
     ideal gas, the leapfrog and a viscous inner boundary (the viscous
     kick's in-kick sound speed) at 128x256 float64 for 20 steps, and
     setups/PDS70.yml (an irradiating star, two planets, 2000 particles)
     at 64x192 float64 for 20 steps with its swarm, the same budgets; the
     planet_accretion and setups/star_planet.yml at 256x512 float32 for
     200 steps and 128x256 float64 for 20, the same budgets, the
     bodies' masses, the frame's rate and the accumulated MassFlow and
     torque grids held to them too; the binary_gcfull on the golden's radii at
     128x256 float64 for 20 steps (the same budget) and float32 on the
     card against float64 on the CPU for 20 steps, each field within
     twice the JAX package's own float32-vs-float64 rel-L2 there
     (flagship.BINARY_F32_LIMITS); OY_Car with its stream's ramp ending in
     the first step at 128x256 and V1504 Cyg at 64x128, float64 for 20
     steps (the same budget), the Roche-lobe tracker's rate held to it
     too; the polytropic flagship at 64x128 (float64 for 20 steps,
     float32 for 100), the planet_disk_sg at 64x192 float32 for 100
     steps, setups/single_planet_no_disk.yml and the FLD-only disk of
     test/FLD1D (64x2, Disk: no) and the flagship with RandomSigma,
     CentrifugalBalance and a companion's disk (SecondaryDisk) at 64x128,
     float64 for 20 steps, the same budgets;
  5. the command line: ``python -m fargocpt_torch start`` (in this process,
     so the launch counters are readable) on examples/adiabatic_disk.yml at
     1024x3072 float32 for two snapshots (about 70 steps), with the counters
     set to 0 just before and read just after (cfl, sources, viscous_kick
     and the whole-transport kernel launched, no other kernel) and the
     native snapshot writer in use; then one snapshot and ``restart last``
     to the second in another directory, which tools/compare_output.py
     --rtol 0 must find bit for bit the first run's, file for file; each
     interval's wall and steps/s, and one snapshot write's seconds and
     bytes; then setups/gamma_cephei_full.yml as it stands (1609x1160)
     through ``start --dtype float32 -N 5``, the transport and ias15 its
     only kernels, snapshot 0's files (Viscosity, AspectRatio and
     MassFlow among them) finite; then setups/CloseBinaries/OY_Car.yml at
     its own 200x200 through ``start --dtype float64`` for four monitor
     intervals (MonitorTimestep 1e-5, the stream's ramp 1e-7 orbits), its
     kernels counted, and one snapshot plus ``restart last``, every file of
     the last snapshot bit for bit, massflow_tracker.bin among them;
     setups/single_planet_no_disk.yml (Disk: no) float64 through four
     monitor intervals of 10 steps (ias15 twice a step, no other kernel,
     the gas untouched) and its restart bit for bit; examples/
     full_physics.yml float64 through ``start -N 20`` (its kernels
     counted, snapshot 0 and particles.bin finite);
  6. the reference binary on the card: the cold_disk_planet (1e-6),
     spreading_ring (1e-9), shocktube_sn (1e-6), longrun_planet (1e-5),
     planet_torque (1e-6), binary_gceph (1e-5), temperature_test (1e-6),
     temperature_fld (1e-6), planet_accretion (1e-6), binary_gcfull
     (1e-5) and shocktube_pvte@lookup (2e-4: the PVTE shock tube on the
     reference's lookup table, built on the card) goldens of
     tests/goldens/ in float64 through the kernels and
     fargocpt_torch.output, each with the launch counters set to 0 before
     and read after, their snapshots against the reference's as
     tests/test_reference_golden.py holds them (each field's largest
     deviation, the hydro step counts and the last dt of misc.bin; the
     temperature goldens' MassFlow.dat at the deviation the JAX package's
     CPU run leaves), and each one's wall time; then the shocktube_pvte
     tube with the float64 bisection solve, ms a step over 20 steps (its
     3283-step golden, 6e-3, is the CPU tests' slow tier);
  7. the radial decomposition (fargocpt_torch.parallel): ranks spawned by
     parallel.launch that share the one card over gloo, each collective
     staged through the host (NCCL, a card a rank, is refused by name
     here). 2 ranks: the flagship at 192x64 float64, one step and a
     monitor interval through cfl, sources, viscous_kick and the
     transport (counted around the sharded calls on every rank) against
     the single-process run on the card (1e-13 and 1e-11 of each field's
     scale, the same step count and landing time), then at 1024x3072
     float32 five steps, each with the sharded CFL (cfl, sources,
     viscous_kick, the transport counted; each field within F32_TOL of
     its scale), ms a
     step of the sharded and the one-process run (ranks sharing one card:
     not a scaling figure) and the bytes each rank sent a step beside
     comm_model; 4 ranks: the 192x64 float64 checks.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 2 and prints neither.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# event_ms: the median over 25 calls of the time between CUDA events around
# a call; perturbed: a simulation's fields with seeded noise (the
# unperturbed disk is axisymmetric, which would leave the azimuthal
# stencils untested)
from fargocpt_torch import telemetry  # noqa: E402
from fargocpt_torch.parallel.comm import KINDS  # noqa: E402
from fargocpt_torch.profile_ops import (  # noqa: E402
    HBM_BYTES_PER_S, OP_FRAGMENTS, RADIAL_SHAPES, event_ms as time_ms,
    perturbed, profile_op, radial_calls, radial_inputs)

NR, NAZ = 1024, 3072          # whole transport route
NR_SPLIT = 1000               # split transport route, named (NR % 16 != 0)
# kernels of each transport route and their launches per step (the staged
# route sweeps once per azimuthal pass: twice with fast transport)
ROUTE_OPS = {"whole": {"transport": 1},
             "split": {"radial_momenta_sweep": 1, "fargo_theta": 1},
             "staged": {"radial_sweep": 1, "theta_sweep": 2,
                        "advect_shift": 1}}

# One row per kernel of fargocpt_torch.ops.kernels.OPS (main() refuses to
# run if the two differ): what it replaces (the TPU kernel's line in
# fargocpt_tpu/ops/pallas_kernels.py; for ias15, pvte_refresh and
# bodies_on_grid, which replace no TPU kernel, the JAX package's while loop
# and what it leaves to XLA), the slice of phase 3 whose launch count the last line but
# one reports, and the float64 tolerance at 130x200 (those of
# tests/test_torch_kernels.py; rtol 1e-11 for the split and staged routes'
# kernels, 1e-12 for artvisc_sn, the roll exact; ias15 1e-13 of its
# state's scale; pvte_refresh at 1024x3072, PVTE_RTOL; bodies_on_grid bit
# for bit). The source is
# fargocpt_torch/csrc/<name>.cu.
PALLAS = "fargocpt_tpu/ops/pallas_kernels.py"
KERNELS = {
    "cfl": (f"{PALLAS}:838", "whole", 1e-12),
    "sources": (f"{PALLAS}:396", "planet_torque", 1e-11),
    "viscous_kick": (f"{PALLAS}:1470", "planet_torque", 1e-10),
    "transport": (f"{PALLAS}:1098", "whole", 1e-11),
    "radial_momenta_sweep": (f"{PALLAS}:192", "split", 1e-11),
    "fargo_theta": (f"{PALLAS}:495", "split", 1e-11),
    "artvisc_sn": (f"{PALLAS}:721", "pds70_gas", 1e-12),
    "radial_sweep": (f"{PALLAS}:573", "staged", 1e-11),
    "theta_sweep": (f"{PALLAS}:106", "staged", 1e-11),
    "advect_shift": (f"{PALLAS}:628", "staged", 0.0),
    "ias15": ("fargocpt_tpu/nbody/ias15.py:236", "planet_torque", 1e-13),
    "pvte_refresh": ("fargocpt_tpu/ops/pvte.py PVTE.gamma_mu (XLA)",
                     "pds70_f64", 1e-10),
    "bodies_on_grid": ("fargocpt_tpu/step.py bodies_on_grid (XLA)",
                       "planet_torque", 0.0),
}
F64_RTOL = {name: row[2] for name, row in KERNELS.items()}
# The card's published peaks (H100 SXM data sheet, at 700 W): the device
# memory rate is profile_ops' HBM_BYTES_PER_S; float32 outside the tensor
# cores:
F32_OPS_PER_S = 67e12
# float64 outside the tensor cores (the same data sheet): ias15's type
F64_OPS_PER_S = 34e12

# f32 at full size, as a fraction of each output's scale (velocities are
# scaled by max|vaz|, as in tests/test_dtype_budget.py; every plane of a
# (K, NR, NAZ) batch by its own max): the kernels read geometry columns
# computed in float64 and the plain versions difference float32 radii
# (Rsup - Rinf ~ 2e-3 r); the two have differed by <= 6.4e-6 of the scale
# on the perturbed flagship state
F32_TOL = 1e-5
# each float32 monitor grid of the planet_accretion trajectory (256x512,
# 200 steps) against the CPU's: twice the JAX package's own float32 run's
# rel-L2 from its float64 run there, rounded up (1.7055e-2, 1.4413e-2,
# 1.0548e-1 by ``python tests/test_torch_monitor_f32.py 256 512 200``;
# the port's own: 1.7812e-2, 1.3858e-2, 1.1464e-1); float64 holds every
# grid to the trajectory's budget
F32_GRID_LIMITS = {"massflow": 3.5e-2, "t_adv": 2.9e-2, "t_grav": 0.22}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def flagship(nr, naz, dtype, device, route=None):
    from fargocpt_torch.flagship import flagship as flagship_config
    from fargocpt_torch.sim import Simulation
    return Simulation(flagship_config(nr, naz), dtype=dtype, device=device,
                      transport_route=route)


def flagship_staged(nr, naz, dtype, device):
    return flagship(nr, naz, dtype, device, route="staged")


def flagship_split(nr, naz, dtype, device):
    return flagship(nr, naz, dtype, device, route="split")


def pds70_gas(nr, naz, dtype, device):
    from fargocpt_torch.flagship import pds70_gas as pds70_gas_config
    from fargocpt_torch.sim import Simulation
    return Simulation(pds70_gas_config(nr, naz), dtype=dtype, device=device)


def pds70(nr, naz, dtype, device, n_particles=16384):
    from fargocpt_torch.flagship import pds70 as pds70_config
    from fargocpt_torch.sim import Simulation
    return Simulation(pds70_config(nr, naz, n_particles), dtype=dtype,
                      device=device)


def pds70_4096(nr, naz, dtype, device):
    return pds70(nr, naz, dtype, device, n_particles=4096)


def planet_disk(nr, naz, dtype, device):
    from fargocpt_torch.flagship import planet_disk as planet_disk_config
    from fargocpt_torch.sim import Simulation
    return Simulation(planet_disk_config(nr, naz), dtype=dtype,
                      device=device)


def planet_torque(nr, naz, dtype, device):
    from fargocpt_torch.flagship import planet_torque as planet_torque_config
    from fargocpt_torch.sim import Simulation
    return Simulation(planet_torque_config(nr, naz), dtype=dtype,
                      device=device)


def planet_accretion(nr, naz, dtype, device):
    from fargocpt_torch.flagship import planet_accretion as accretion_config
    from fargocpt_torch.sim import Simulation
    return Simulation(accretion_config(nr, naz), dtype=dtype, device=device)


def from_yaml(path, nr, naz, dtype, device, **over):
    """A setup file of the repo on an ``nr`` x ``naz`` grid."""
    from fargocpt_torch.config import Config
    from fargocpt_torch.flagship import setup_file
    from fargocpt_torch.sim import Simulation
    cfg = setup_file(os.path.join(HERE, path), nr, naz, **over)
    cfg.pop("OutputDir", None)
    return Simulation(Config.from_dict(cfg), dtype=dtype, device=device)


def binary_gcfull(nr, naz, dtype, device):
    """flagship.binary_gcfull: setups/gamma_cephei_full.yml's physics (the
    circumbinary-disk menu) at its own radii."""
    from fargocpt_torch.flagship import binary_gcfull as binary_config
    from fargocpt_torch.sim import Simulation
    return Simulation(binary_config(nr, naz), dtype=dtype, device=device)


def binary_gcfull_golden_radii(nr, naz, dtype, device):
    """The same physics on the binary_gcfull golden's radii (0.05 to 12:
    the e = 0.4 secondary inside a resolved grid)."""
    from fargocpt_torch.flagship import binary_gcfull as binary_config
    from fargocpt_torch.sim import Simulation
    return Simulation(binary_config(nr, naz, Rmin="0.05", Rmax="12"),
                      dtype=dtype, device=device)


def oy_car(nr, naz, dtype, device, **over):
    """flagship.oy_car: setups/CloseBinaries/OY_Car.yml (the Roche-lobe-fed
    dwarf-nova disk, the Euler step) with FirstDT 1e-7, so a short run
    reaches its CFL-limited dt (~3e-7) in a few steps."""
    from fargocpt_torch.flagship import oy_car as oy_car_config
    from fargocpt_torch.sim import Simulation
    return Simulation(oy_car_config(nr, naz, FirstDT="1e-7", **over),
                      dtype=dtype, device=device)


def oy_car_stream(nr, naz, dtype, device):
    """OY_Car with its stream's ramp ending in the first step, so the
    stream carries mass within a short run."""
    return oy_car(nr, naz, dtype, device, ROFrampingtime="1e-7")


def v1504cyg(nr, naz, dtype, device):
    """flagship.v1504cyg: setups/V1504Cyg.yml as it stands (PVTE, S-curve
    cooling, the Roche-lobe stream, the leapfrog)."""
    from fargocpt_torch.flagship import v1504cyg as v1504cyg_config
    from fargocpt_torch.sim import Simulation
    return Simulation(v1504cyg_config(nr, naz), dtype=dtype, device=device)


def binary_gceph(nr, naz, dtype, device):
    """The binary_gceph golden's physics: a gamma-Cephei-like binary, the
    leapfrog, an ideal gas with thermal cooling."""
    return from_yaml("tests/goldens/binary_gceph/setup.yml", nr, naz, dtype,
                     device)


def quickstart_adiabatic_leapfrog(nr, naz, dtype, device):
    """examples/quickstart.yml with an ideal gas, the leapfrog and a
    viscous inner boundary: the viscous kick's in-kick sound speed feeds
    the boundary and kick 2's smoothing plane. FirstDT 1e-3, as the
    flagship's: from the file's default first dt, 20 steps move the fields
    by less than 1e-9."""
    return from_yaml("examples/quickstart.yml", nr, naz, dtype, device,
                     EquationOfState="Ideal", Integrator="LeapFrog",
                     InnerBoundary="viscous", FirstDT=1e-3)


def star_planet(nr, naz, dtype, device):
    """setups/star_planet.yml: the Euler step in the corotating frame."""
    return from_yaml("setups/star_planet.yml", nr, naz, dtype, device)


def pds70_setup(nr, naz, dtype, device):
    """setups/PDS70.yml: an irradiating star, two planets, 2000 dust
    particles."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # CartesianParticles, midpoint
        return from_yaml("setups/PDS70.yml", nr, naz, dtype, device)


def planet_disk_sg(nr, naz, dtype, device):
    """flagship.planet_disk_sg: examples/quickstart.yml with SelfGravity:
    Yes (the Bessel kernel): a planet in a self-gravitating disk."""
    from fargocpt_torch.flagship import planet_disk_sg as sg_config
    from fargocpt_torch.sim import Simulation
    return Simulation(sg_config(nr, naz), dtype=dtype, device=device)


def full_physics(nr, naz, dtype, device):
    """flagship.full_physics: examples/full_physics.yml as it stands (FLD,
    symmetric self-gravity, surface cooling, an irradiating star, 2000
    diffusing particles), FirstDT 1e-3."""
    from fargocpt_torch.flagship import full_physics as fp_config
    from fargocpt_torch.sim import Simulation
    return Simulation(fp_config(nr, naz, FirstDT="1e-3"), dtype=dtype,
                      device=device)


def flagship_with(over: dict, label: str):
    """A setup function: the flagship with ``over``'s keys."""
    def setup(nr, naz, dtype, device):
        from fargocpt_torch.config import Config
        from fargocpt_torch.flagship import FLAGSHIP
        from fargocpt_torch.sim import Simulation
        return Simulation(Config.from_dict(dict(
            FLAGSHIP, Nrad=str(nr), Naz=str(naz), **over)), dtype=dtype,
            device=device)
    setup.__name__ = label
    return setup


# the polytropic EoS and the long tail's initial conditions on the flagship
polytropic = flagship_with({"EquationOfState": "Polytropic"}, "polytropic")
sigma_randomize = flagship_with({"RandomSigma": "Yes", "FeatureSize": "0.05"},
                                "sigma_randomize")
centrifugal_balance = flagship_with({"CentrifugalBalance": "Yes"},
                                    "centrifugal_balance")
# a companion of 0.3 at r = 1.2, whose Roche lobe holds cells
secondary_disk = flagship_with({
    "SecondaryDisk": "Yes", "SigmaSlope": "1.0",
    "ProfileCutoffPointOuter": "0.8", "ProfileCutoffWidthOuter": "0.1",
    "nbody": [{"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
              {"name": "companion", "semi-major axis": "1.2",
               "mass": "0.3"}]}, "secondary_disk")


def single_planet_no_disk(nr, naz, dtype, device):
    """setups/single_planet_no_disk.yml (Disk: no) on an nr x naz grid."""
    from fargocpt_torch.flagship import single_planet_no_disk as nd_config
    from fargocpt_torch.sim import Simulation
    return Simulation(nd_config(nr, naz), dtype=dtype, device=device)


def fld1d(nr, naz, dtype, device):
    """flagship.fld1d: the FLD-only disk of the reference's test/FLD1D."""
    from fargocpt_torch.flagship import fld1d as fld1d_config
    from fargocpt_torch.sim import Simulation
    return Simulation(fld1d_config(nr, naz), dtype=dtype, device=device)


# --- phase 2 -----------------------------------------------------------------

def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class FlopCounter(TorchDispatchMode):
    """Counts the floating-point operations of the PyTorch calls made
    under it: each arithmetic op, math function, min/max and compare on
    floating-point tensors counts once per element of its largest operand
    or result (so a reduction counts its input). Data movement (copies,
    casts, cat, stack, roll, gather) and selects count nothing."""

    COUNTED = frozenset((
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt",
        "reciprocal", "exp", "log", "pow", "floor", "sign", "maximum",
        "minimum", "clamp", "clamp_min", "clamp_max", "max", "min", "amax",
        "amin", "sum", "mean", "gt", "lt", "ge", "le", "eq", "ne"))

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in self.COUNTED:
            ts = [t for t in (*args, *(kwargs or {}).values(),
                              *(out if isinstance(out, tuple) else (out,)))
                  if torch.is_tensor(t)]
            if any(t.is_floating_point() for t in ts):
                self.flops += max(t.numel() for t in ts)
        return out


def flops_of(fn) -> int:
    """The floating-point operations of one call of ``fn``, a plain
    version: the function itself, each value computed once per element."""
    with FlopCounter() as fc:
        fn()
    return fc.flops


def bound(inputs, outputs, flops, ops_per_s=F32_OPS_PER_S) -> dict:
    """Least time on the card: each input read once and each output
    written once at the memory rate, against the function's operations
    at the rate of their type (float32 unless given); the larger of the
    two."""
    t_bytes = (nbytes(inputs) + nbytes(outputs)) / HBM_BYTES_PER_S
    t_ops = flops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def op_calls(ctx, f, q, bodies, omega, dt):
    """name -> (kernel call, plain call, output names, inputs) of the
    whole route's four ops on one state."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    zero = torch.zeros((), dtype=torch.float64, device=f["sigma"].device)
    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    fields = [s, vr, va, e, ctx.cols]
    return {
        "cfl": (lambda: (K.cfl(ctx, s, vr, va, e, *q),),
                lambda: (K.cfl_plain(ctx, s, vr, va, e, *q),), ("dt",),
                fields + list(q)),
        "sources": (
            lambda: K.sources(ctx, s, vr, va, e, bodies, (zero, zero),
                              omega, dt),
            lambda: K.sources_plain(ctx, s, vr, va, e, bodies, (zero, zero),
                                    omega, dt), ("vrad", "vaz"),
            fields + [ctx.cos_row, ctx.sin_row]),
        "viscous_kick": (
            lambda: K.viscous_kick(ctx, s, vr, va, e, dt, 0.0),
            lambda: K.viscous_kick_plain(ctx, s, vr, va, e, dt, 0.0),
            ("vrad", "vaz", "energy", "qplus", "qminus"), fields),
        "transport": (
            lambda: K.transport(ctx, s, vr, va, e, omega, dt, shift,
                                route="whole"),
            lambda: K.transport_plain(ctx, s, vr, va, e, omega, dt, shift,
                                      route="whole"),
            ("sigma", "vrad", "vaz", "energy", "mass_flux"),
            fields + list(shift)),
    }


def split_calls(ctx, f, omega, dt):
    """name -> (kernel call, plain call, output names, inputs) of the split
    route's two ops on one state, each fed what the transport feeds it."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    g, phys = ctx.g, ctx.phys
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    vmean, nshift, vconst = tr.fargo_shift(g, va, dt)
    base = tr.sigma_flux(phys, g, s, vr, dt)
    rms = (s, vr, va, e, base, dt, omega)
    qs = K.radial_momenta_sweep_plain(ctx, *rms)
    vres = va - vmean
    if not phys.fast_transport:
        vres = vres + vconst
    ft = (qs, vres, vconst, nshift, dt, phys.fast_transport)
    return {
        "radial_momenta_sweep": (
            lambda: (K.radial_momenta_sweep(ctx, *rms),),
            lambda: (K.radial_momenta_sweep_plain(ctx, *rms),), ("qs",),
            [s, vr, va, e, base, ctx.cols]),
        "fargo_theta": (
            lambda: (K.fargo_theta(ctx, *ft),),
            lambda: (K.fargo_theta_plain(ctx, *ft),), ("qs",),
            [qs, vres, vconst, nshift, ctx.cols]),
    }


def staged_calls(ctx, f, omega, dt, nshift=None):
    """name -> (kernel call, plain call, output names, inputs, library
    call) of the staged route's three ops on one state, each fed what the
    transport feeds it: the stacked momenta to the radial sweep, its result
    and the residual velocity to the azimuthal sweep, the twice-swept
    batch to the roll. The roll's library call is torch.gather with the
    index built beforehand."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    g, phys = ctx.g, ctx.phys
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    vmean, own_shift, vconst = tr.fargo_shift(g, va, dt)
    nshift = own_shift if nshift is None else nshift
    base = tr.sigma_flux(phys, g, s, vr, dt)
    qs0 = tr.momenta_batch(phys, g, s, vr, va, e, omega.to(s.dtype))
    qs1 = K.radial_sweep_plain(ctx, qs0, s, vr, base, dt)
    vres = va - vmean
    if not phys.fast_transport:
        vres = vres + vconst
    qs2 = K.theta_sweep_plain(ctx, qs1, vres, dt)
    if phys.fast_transport:
        qs2 = K.theta_sweep_plain(ctx, qs2,
                                  vconst.expand_as(vres).contiguous(), dt)
    j = torch.arange(g.naz, device=s.device)
    index = torch.remainder(j[None, :] - nshift[:, None].to(j.dtype),
                            g.naz).expand_as(qs2).contiguous()
    return {
        "radial_sweep": (
            lambda: (K.radial_sweep(ctx, qs0, s, vr, base, dt),),
            lambda: (K.radial_sweep_plain(ctx, qs0, s, vr, base, dt),),
            ("qs",), [qs0, s, vr, base, ctx.cols], None),
        "theta_sweep": (
            lambda: (K.theta_sweep(ctx, qs1, vres, dt),),
            lambda: (K.theta_sweep_plain(ctx, qs1, vres, dt),), ("qs",),
            [qs1, vres, ctx.cols], None),
        "advect_shift": (
            lambda: (K.advect_shift(qs2, nshift),),
            lambda: (K.advect_shift_plain(qs2, nshift),), ("qs",),
            [qs2, nshift], lambda: torch.gather(qs2, -1, index)),
    }


def log_launches(name, kern, fragments, k_quant, plane_bytes, gpu) -> dict:
    """The device time of each launch of one call of ``kern``
    (torch.profiler), the bytes it must move and the memory rate that
    makes, and the wrapper's share of the event time."""
    r = profile_op(kern, fragments, k_quant, plane_bytes)
    log(f"  {name} launch by launch: "
        + "; ".join(f"{x['kernel']} {x['device_ms']:.4f} ms, "
                    f"{x['bytes'] / 1e6:.1f} MB, {x['tb_per_s']:.3f} TB/s "
                    f"({100 * x['share_of_memory_rate']:.1f}% of "
                    f"{HBM_BYTES_PER_S / 1e12} TB/s)" for x in r["launches"])
        + f"; device {r['device_ms']:.4f} ms of {r['event_ms']:.4f} ms by "
        f"events (wrapper {r['wrapper_ms']:.4f} ms, host "
        f"{r['host_ms']:.4f} ms a call, {r['pytorch_launches']:.1f} other "
        f"device launches a call) [{gpu}]")
    return r


def output_scales(name, oname, ref, f) -> list[float]:
    """The scale each output's error is measured against: velocities by
    max|vaz| (as in tests/test_dtype_budget.py), each plane of a
    (K, NR, NAZ) batch by its own max (rp and rm, sigma vrad, are ~1e-4
    of the angular momenta), every other quantity by its own max.
    artvisc_sn adds small increments to its inputs (on the perturbed PDS70
    state ~3e-5 of max|vaz| to vaz, ~8e-6 of max e to e), so each of its
    outputs is measured against the plain version's increment, max
    |plain - input| in float64 (the error of the increments is the error of
    the outputs). One float32 ulp of vaz or e is then ~5e-3 of the scale:
    the check holds only where kernel and plain agree bit for bit, as a
    kernel that follows its plain version operation by operation does. An
    increment of 0 everywhere raises, as it would test nothing."""
    if name == "artvisc_sn":
        inc = float((ref.double() - f[oname].double()).abs().max())
        if not inc > 0.0:
            raise AssertionError(f"artvisc_sn leaves {oname} unchanged")
        return [inc]
    if oname in ("vrad", "vaz"):
        return [float(f["vaz"].abs().max())]
    if oname == "qs":
        return [float(ref[k].abs().max()) for k in range(ref.shape[0])]
    return [float(ref.abs().max())]


def check_f64(name, got, ref, names, f, nr, floors=None) -> float:
    """Each output within rtol F64_RTOL[name] and atol 1e-13 of its scale
    (parity_f64_ragged's criterion; the roll exact), or within
    ``floors[name]`` where that is larger; raises otherwise. An output
    that updates an input field is logged with how far the plain version
    moved it (max|p-in| / max|in|). Returns the largest absolute error."""
    max_abs = 0.0
    floor = (floors or {}).get(name, 0.0)
    for oname, a, b in zip(names, got, ref):
        moved = ""
        if oname in f and f[oname].shape == b.shape:
            moved = (f"; moved {float((b - f[oname]).abs().max()):.3e} of "
                     f"{float(f[oname].abs().max()):.3e}")
        if floor:
            moved += f"; floor {floor:.3e}"
        a, b = a.cpu().numpy(), b.cpu().numpy()
        atol = max(1e-13 * float(np.abs(b).max()), floor) \
            if F64_RTOL[name] else 0.0
        err = float(np.abs(a - b).max())
        max_abs = max(max_abs, err)
        log(f"  {name:20s} {oname:9s} f64 {nr}x{f['sigma'].shape[-1]}: "
            f"max|k-p| = {err:.3e}  (rtol {F64_RTOL[name]:.0e}, atol "
            f"{atol:.1e}{moved})")
        np.testing.assert_allclose(a, b, rtol=F64_RTOL[name], atol=atol,
                                   err_msg=f"{name}.{oname}")
    return max_abs


def check_f32(name, got, ref, names, f, nr) -> float:
    """Worst error over the outputs as a fraction of their scale; raises
    above F32_TOL. Returns the largest absolute error."""
    worst, max_abs = 0.0, 0.0
    for oname, a, b in zip(names, got, ref):
        scales = output_scales(name, oname, b, f)
        parts = [(a[k], b[k]) for k in range(b.shape[0])] \
            if oname == "qs" else [(a, b)]
        errs = [float((x - y).abs().max()) for x, y in parts]
        # an output that is zero everywhere (the isothermal energy and Q
        # grids) must come out zero
        rel = max(e / sc if sc > 0.0 else (0.0 if e == 0.0 else math.inf)
                  for e, sc in zip(errs, scales))
        max_abs = max(max_abs, *errs)
        worst = max(worst, rel)
        log(f"  {name:20s} {oname:9s} f32 {nr}x{f['sigma'].shape[-1]}: "
            f"max|k-p| = {max(errs):.3e}  / scale = {rel:.3e}  (scale "
            f"{max(scales):.3e})")
    if not worst <= (0.0 if F64_RTOL.get(name) == 0.0 else F32_TOL):
        raise AssertionError(f"{name}: f32 kernel/plain mismatch "
                             f"{worst:.3e} > {F32_TOL} (the roll: > 0)")
    return max_abs


def measure(calls, f, nr, check=check_f32, ops_per_s=F32_OPS_PER_S) -> dict:
    """Parity (``check``), times and bound (operations at ``ops_per_s``)
    of each kernel in ``calls``."""
    out = {}
    naz = f["sigma"].shape[-1]
    for name, (kern, plain, names, inputs, *library) in calls.items():
        library = library[0] if library else None
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        max_abs = check(name, got, ref, names, f, nr)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        library_ms = None
        if library is not None:
            if not torch.equal(library(), ref[0]):
                raise AssertionError(f"{name}: the library call computes "
                                     "another function")
            library_ms = time_ms(library)
        flops = flops_of(plain)
        b = bound(inputs, got, flops, ops_per_s)
        log(f"  {name:20s} kernel {ms:.4f} ms   plain {plain_ms:.4f} ms   "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"{nbytes(inputs) + nbytes(got)} B, {flops} flops = "
            f"{flops / (nr * naz):.1f} per cell)"
            + ("" if library_ms is None
               else f"   library call {library_ms:.4f} ms"))
        out[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     **b, "library_ms": library_ms}
    return out


def parity_f32_flagship(sim, gpu) -> dict:
    """The whole route's four kernels against their plain versions at
    1024x3072 on the perturbed flagship state, and the launches of the
    whole-transport kernel, the viscous kick and the sources one by one."""
    st = sim.state
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    bodies = sim.stepper.bodies_on_grid(st.nbody, sim.time)
    calls = op_calls(sim.stepper.ops, f, (st.qplus, st.qminus), bodies,
                     st.omega_frame, dt)
    out = measure(calls, f, NR)
    for name in ("transport", "viscous_kick", "sources", "cfl"):
        out[name]["per_launch"] = log_launches(
            name, calls[name][0], OP_FRAGMENTS[name],
            6 if sim.stepper.ops.phys.is_adiabatic else 5,
            nbytes([f["sigma"]]), gpu)
    return out


def hydro_dt(sim) -> torch.Tensor:
    """The setup's CFL dt without its heating/cooling term (Q+ and Q- set
    to 0): the dt of its flow alone."""
    st = sim.state
    zero = torch.zeros_like(st.qplus)
    return sim.stepper.cfl_dt(st.replace(qplus=zero, qminus=zero), sim.time)


def transport_parity(sim, check=check_f32, dt=None) -> float:
    """The whole-transport kernel against its plain version on a setup's
    state at its own grid, on its CFL dt or on ``dt`` (the step's fargo
    shift; the transport's inputs are the fields the step hands it):
    binary_gcfull at 1609x1160 in float32, each output within F32_TOL of
    its scale; V1504 Cyg at 450x1070 in float64 (``check_f64``), on
    ``hydro_dt``, since its CFL dt (~1e-18; ROADMAP C) moves no field.
    Given ``dt``, each field must move by more than 1e3 times the kernel's
    rtol of its scale, so that the comparison is seen to bite. Returns the
    largest absolute error."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    st, ctx = sim.state, sim.stepper.ops
    f = {k: getattr(st.fields, k) for k in ("sigma", "vrad", "vaz",
                                            "energy")}
    given = dt is not None
    if not given:
        dt = sim.stepper.cfl_dt(st, sim.time)
    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
            st.omega_frame, dt, shift)
    got = K.transport(*args, route="whole")
    ref = K.transport_plain(*args, route="whole")
    torch.cuda.synchronize()
    names = ("sigma", "vrad", "vaz", "energy", "mass_flux")
    # a locally isothermal energy is 0 throughout: left out
    moved = {k: float((out - f[k]).abs().max() / f[k].abs().max())
             for k, out in zip(names, ref)
             if k in f and bool(f[k].abs().max() > 0)}
    log(f"  transport on dt {float(dt):.4e}: the plain version moves each "
        "field by (max|out-in| / max|in|) "
        + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
    if given and not min(moved.values()) > 1e3 * F64_RTOL["transport"]:
        raise AssertionError(f"transport on dt {float(dt)!r} moves the "
                             f"fields by {moved} only")
    return check("transport", got, ref, names, f, sim.geometry.nrad)


def potential_ulp_floor(sim, f, bodies, dt) -> float:
    """How far one ulp of the N-body potential moves a velocity through
    the sources' potential gradient, twice: 2 dt ulp(max|pot|) over the
    least cell spacing (a radial cell or r dphi at the inner edge). The
    sources kernel and its plain version evaluate the potential (the
    smoothing's powers, the square root) each in its own order, so they
    may differ by an ulp of it in a cell; where the velocity the gradient
    updates is far smaller than the gradient's terms (examples/
    full_physics.yml's v_rad, ~1e-4 against dt |grad pot| ~0.25 at its
    inner edge), that ulp is far above 1e-13 of the velocity's scale."""
    from fargocpt_torch.ops import gravity
    from fargocpt_torch.ops.kernels import derived
    ctx = sim.stepper.ops
    _, _, h = derived(ctx, f["sigma"], f["energy"])
    zero = torch.zeros((), dtype=torch.float64, device=f["sigma"].device)
    pot = gravity.nbody_potential(ctx.phys, ctx.constants, ctx.g, bodies,
                                  bodies.x.shape[0], *ctx.cell_xy(), h,
                                  zero, zero)
    big = pot.abs().max()
    ulp = float(torch.nextafter(big, 2.0 * big) - big)
    radii = np.asarray(sim.geometry.radii, np.float64)
    spacing = min(float(np.diff(radii).min()),
                  float(radii[0]) * 2.0 * math.pi / sim.geometry.naz)
    return 2.0 * float(dt) * ulp / spacing


def cv_kernel_parity(sim, names, f=None, floors=False) -> dict:
    """Each kernel of ``names`` against its plain version on a setup's own
    state (or the fields ``f``) at its own grid, float64 (``check_f64``),
    with its ms beside the plain version's and its bound at the float64
    rate: OY_Car's cfl, sources, artvisc_sn and transport at 200x200 (a
    partial 16-row strip, a ring shorter than one 256-cell block), those
    of examples/full_physics.yml at 128x256. The dt is ``hydro_dt``: on
    OY_Car's CFL dt (~6e-7, the heating/cooling limit) artvisc_sn moves
    the energy by less than its atol. With ``floors`` the sources' atol is
    at least ``potential_ulp_floor``."""
    st = sim.state
    if f is None:
        f = {k: getattr(st.fields, k) for k in ("sigma", "vrad", "vaz",
                                                "energy")}
    ctx = sim.stepper.ops
    dt = hydro_dt(sim)
    bodies = sim.stepper.bodies_on_grid(st.nbody, sim.time)
    calls = op_calls(ctx, f, (st.qplus, st.qminus), bodies, st.omega_frame,
                     dt)
    calls.update(artvisc_calls(ctx, f, dt))
    check = check_f64
    if floors:
        check = partial(check_f64, floors={
            "sources": potential_ulp_floor(sim, f, bodies, dt)})
    return measure({k: calls[k] for k in names}, f, sim.geometry.nrad,
                   check=check, ops_per_s=F64_OPS_PER_S)


def artvisc_calls(ctx, f, dt):
    """name -> (kernel call, plain call, output names, inputs) of
    artvisc_sn on one state."""
    from fargocpt_torch.ops import kernels as K
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"], dt)
    return {"artvisc_sn": (lambda: K.artvisc_sn(*args),
                           lambda: K.artvisc_sn_plain(*args),
                           ("vrad", "vaz", "energy"),
                           [f["sigma"], f["vrad"], f["vaz"], f["energy"],
                            ctx.cols])}


def parity_f32_pds70(sim) -> dict:
    """artvisc_sn against its plain version at 1024x3072 on the perturbed
    PDS70 gas state."""
    f = perturbed(sim)
    return measure(artvisc_calls(sim.stepper.ops, f,
                                 sim.stepper.cfl_dt(sim.state)), f, NR)


def parity_f32_split(sim, gpu) -> tuple[dict, dict]:
    """The split route's two kernels against their plain versions at
    1000x3072 on the perturbed flagship state; then the split route as a
    whole against the whole-transport kernel on the same state (outputs
    and times). Returns (per-kernel results, route times in ms)."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    st, ctx = sim.state, sim.stepper.ops
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    calls = split_calls(ctx, f, st.omega_frame, dt)
    out = measure(calls, f, NR_SPLIT)
    for name in ("radial_momenta_sweep", "fargo_theta"):
        out[name]["per_launch"] = log_launches(
            name, calls[name][0], OP_FRAGMENTS[name],
            6 if ctx.phys.is_adiabatic else 5, nbytes([f["sigma"]]), gpu)

    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
            st.omega_frame, dt, shift)
    routes = {r: (lambda r=r: K.transport(*args, route=r))
              for r in ("split", "whole")}
    names = ("sigma", "vrad", "vaz", "energy", "mass_flux")
    check_f32("split vs whole", routes["split"](), routes["whole"](), names,
              f, NR_SPLIT)
    # in turns: split, whole, whole, split
    t = {"split": [], "whole": []}
    for r in ("split", "whole", "whole", "split"):
        t[r].append(time_ms(routes[r]))
    times = {r: float(np.mean(v)) for r, v in t.items()}
    log(f"  transport at {NR_SPLIT}x{NAZ} f32: split route "
        f"{times['split']:.4f} ms, whole-transport kernel "
        f"{times['whole']:.4f} ms (event medians, mean of two turns each)")
    return out, times


def parity_f32_staged(sim, gpu) -> tuple[dict, dict]:
    """The staged route's three kernels against their plain versions at
    1024x3072 on the perturbed flagship state; then the staged route as a
    whole against the whole-transport kernel on the same state, and the
    three routes' times in turns. Returns (per-kernel results, route times
    in ms)."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    st, ctx = sim.state, sim.stepper.ops
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    calls = staged_calls(ctx, f, st.omega_frame, dt)
    out = measure(calls, f, NR)
    for name in ("radial_sweep", "theta_sweep", "advect_shift"):
        out[name]["per_launch"] = log_launches(
            name, calls[name][0], OP_FRAGMENTS[name],
            6 if ctx.phys.is_adiabatic else 5, nbytes([f["sigma"]]), gpu)

    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
            st.omega_frame, dt, shift)
    routes = {r: (lambda r=r: K.transport(*args, route=r)) for r in K.ROUTES}
    names = ("sigma", "vrad", "vaz", "energy", "mass_flux")
    check_f32("staged vs whole", routes["staged"](), routes["whole"](),
              names, f, NR)
    order = ("staged", "split", "whole", "whole", "split", "staged")
    t = {r: [] for r in K.ROUTES}
    for r in order:
        t[r].append(time_ms(routes[r]))
    times = {r: float(np.mean(v)) for r, v in t.items()}
    log(f"  transport at {NR}x{NAZ} f32 in turns {order}: "
        + ", ".join(f"{r} route {times[r]:.4f} ms" for r in K.ROUTES)
        + " (event medians of 25 calls, mean of two turns each)")
    return out, times


def parity_f64_ragged(device) -> None:
    """Kernel vs plain at 130x200 float64 on seeded random fields: the
    whole route's four, then the split route's two and the staged route's
    three over K = 5 and 6, both limiters and one or two azimuthal sweeps,
    with shifts of either sign and beyond one turn of the ring."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops.gravity import BodiesOnGrid
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    nr, naz = 130, 200
    phys = Physics(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
                   aspectratio_ref=0.05, flaring_index=0.25,
                   artificial_viscosity="sn", heating_viscous=True,
                   cooling_beta_enabled=True, cooling_beta=10.0,
                   minimum_temperature=1e-6, sigma0=1.0, sigma_floor=1e-6,
                   thickness_smoothing=0.6, imposed_disk_drift=1e-4)
    geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    constants = Constants.from_units(Units())
    ctx = K.KernelContext(phys, constants, geometry, torch.float64, device)
    rng = np.random.default_rng(11)
    t = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                               device=device)
    sigma = rng.random((nr, naz)) + 0.5
    sigma[nr // 3, 3:7] = 5e-6
    f = {"sigma": t(sigma), "energy": t(rng.random((nr, naz)) * 1e-3 + 1e-3),
         "vaz": t((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
         "vrad": t((rng.random((nr + 1, naz)) - 0.5) * 0.05)}
    q = (t(rng.random((nr, naz)) * 1e-6), t(rng.random((nr, naz)) * 1e-6))
    bodies = BodiesOnGrid(x=t([0.0, 1.0]), y=t([0.0, 0.3]),
                          mass=t([1.0, 1e-3]),
                          cubic_smoothing_radius=t([0.0, 0.05]))

    def check(name, label, got, ref, onames):
        for oname, a, b in zip(onames, got, ref):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            atol = 1e-13 * float(np.abs(b).max()) if F64_RTOL[name] else 0.0
            err = float(np.abs(a - b).max())
            log(f"  {name:20s} {oname:9s} f64 {nr}x{naz}{label}: max|k-p| = "
                f"{err:.3e}  (rtol {F64_RTOL[name]:.0e}, atol {atol:.1e})")
            np.testing.assert_allclose(a, b, rtol=F64_RTOL[name], atol=atol,
                                       err_msg=f"{name}.{oname}{label}")

    calls = op_calls(ctx, f, q, bodies, t(0.4), t(0.003))
    for name, (kern, plain, names, _) in calls.items():
        check(name, "", kern(), plain(), names)
    for dissipation in (True, False):
        c = K.KernelContext(phys.with_(artificial_viscosity_dissipation=(
            dissipation)), constants, geometry, torch.float64, device)
        kern, plain, names, _ = artvisc_calls(c, f, t(0.01))["artvisc_sn"]
        check("artvisc_sn", f" dissipation={dissipation}", kern(), plain(),
              names)

    dt, omega = t(0.01), t(0.3)
    shifts = torch.tensor(rng.integers(-2 * naz, 2 * naz, nr),
                          dtype=torch.int32, device=device)
    if not (bool((shifts < 0).any()) and bool((shifts > 0).any())):
        raise AssertionError("the shifts need both signs")
    for eos_name in ("adiabatic", "isothermal"):
        for limiter in (0, 1):
            c = K.KernelContext(phys.with_(eos=eos_name,
                                           flux_limiter_type=limiter),
                                constants, geometry, torch.float64, device)
            label = f" K={6 if eos_name == 'adiabatic' else 5} " \
                f"limiter={limiter}"
            for fast in (True, False):
                cf = K.KernelContext(c.phys.with_(fast_transport=fast),
                                     constants, geometry, torch.float64,
                                     device)
                staged = staged_calls(cf, f, omega, dt, nshift=shifts)
                for name, (kern, plain, names, *_) in staged.items():
                    if fast or name == "theta_sweep":
                        check(name, label + f" fast={fast}", kern(), plain(),
                              names)
            calls = split_calls(c, f, omega, dt)
            for name in ("radial_momenta_sweep", "fargo_theta"):
                kern, plain, names, inputs = calls[name]
                if name == "radial_momenta_sweep":
                    check(name, label, kern(), plain(), names)
                    continue
                qs, vres, vconst = inputs[:3]
                for two_pass in (True, False):
                    ft = (qs, vres, vconst, shifts, dt, two_pass)
                    check(name, label + f" two_pass={two_pass}",
                          (K.fargo_theta(c, *ft),),
                          (K.fargo_theta_plain(c, *ft),), names)


# Shapes that cross every edge of the viscous kick's and the sources' tiles
# (16 rows x 64 columns of outputs both, the row tiles covering vrad's
# NR + 1 rows): NR and NAZ one under, on and one over a tile, several tiles
# with a ragged last one, NR = 4, rings of 1 and 3 cells (shorter than the
# viscous kick's halo of 2 cells each way).
KICK_SHAPES = ((4, 1), (4, 3), (15, 63), (16, 64), (17, 65), (31, 64),
               (32, 65), (33, 130))


def kick_tile_edges(device) -> None:
    """viscous_kick and sources against their plain versions over
    KICK_SHAPES on seeded random fields (a patch of near-floor cells where
    the ring is long enough), SN and TW artificial viscosity, both EoS,
    a star and two planets with cubic smoothing radii inside the grid.
    float64 at the rtol of KERNELS, float32 at F32_TOL of each output's
    scale (the velocities': max|vaz|, or the output's own where the kick
    on a near-floor cell makes it larger)."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops.gravity import BodiesOnGrid
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    constants = Constants.from_units(Units())
    outputs = {"viscous_kick": ("vrad", "vaz", "energy", "qplus", "qminus"),
               "sources": ("vrad", "vaz")}
    f64_atol = {"viscous_kick": (1e-13, 1e-13, 1e-16, 1e-18, 1e-18),
                "sources": (1e-13, 1e-13)}
    for dtype in (torch.float64, torch.float32):
        worst = dict.fromkeys(outputs, 0.0)
        for nr, naz in KICK_SHAPES:
            geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
            rng = np.random.default_rng(19)
            sigma = rng.random((nr, naz)) + 0.5
            sigma[nr // 3, 3:7] = 5e-6
            raw = {"sigma": sigma,
                   "energy": rng.random((nr, naz)) * 1e-3 + 1e-3,
                   "vaz": (rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                   "vrad": (rng.random((nr + 1, naz)) - 0.5) * 0.05}
            f = {k: torch.tensor(v, dtype=dtype, device=device)
                 for k, v in raw.items()}
            t64 = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                                         device=device)
            bodies = BodiesOnGrid(x=t64([0.0, 1.0, -0.4]),
                                  y=t64([0.0, 0.3, 1.1]),
                                  mass=t64([1.0, 1e-3, 3e-4]),
                                  cubic_smoothing_radius=t64([0.0, 0.3, 0.2]))
            dt = torch.tensor(0.003, dtype=dtype, device=device)
            fields = (f["sigma"], f["vrad"], f["vaz"], f["energy"])
            for eos_name in ("adiabatic", "isothermal"):
                for artvisc in ("sn", "tw"):
                    ctx = K.KernelContext(
                        Physics(eos=eos_name, adiabatic_index=1.4,
                                viscous_alpha=1e-3, aspectratio_ref=0.05,
                                flaring_index=0.25,
                                artificial_viscosity=artvisc,
                                heating_viscous=True,
                                cooling_beta_enabled=True, cooling_beta=10.0,
                                minimum_temperature=1e-6, sigma0=1.0,
                                sigma_floor=1e-6, thickness_smoothing=0.6,
                                imposed_disk_drift=1e-4),
                        constants, geometry, dtype, device)
                    calls = {
                        "viscous_kick": (ctx, *fields, dt, 0.0),
                        "sources": (ctx, *fields, bodies,
                                    (t64(1e-3), t64(-2e-3)), t64(0.4), dt)}
                    for name, args in calls.items():
                        got = getattr(K, name)(*args)
                        ref = getattr(K, name + "_plain")(*args)
                        label = f"{name} {nr}x{naz} {eos_name} {artvisc}"
                        for oname, a, b, atol in zip(outputs[name], got, ref,
                                                     f64_atol[name]):
                            if dtype == torch.float64:
                                np.testing.assert_allclose(
                                    a.cpu().numpy(), b.cpu().numpy(),
                                    rtol=F64_RTOL[name], atol=atol,
                                    err_msg=f"{label} {oname}")
                            scale = float(b.abs().max())
                            if oname in ("vrad", "vaz"):
                                scale = max(scale,
                                            float(f["vaz"].abs().max()))
                            err = float((a - b).abs().max())
                            if err > 0.0:
                                worst[name] = max(worst[name], err / scale)
        for name, w in worst.items():
            log(f"  {name:20s}  tile edges {KICK_SHAPES} "
                f"{str(dtype).removeprefix('torch.')}, SN and TW, both EoS: "
                f"max|k-p| / scale = {w:.3e}")
            if dtype == torch.float32 and not w <= F32_TOL:
                raise AssertionError(f"{name} across its tile edges, "
                                     f"float32: {w:.3e} > {F32_TOL} of scale")


# Shapes that cross every edge of cfl's ring blocks (one block of 256
# threads a ring; a ring's vaz in shared memory up to 40 KB: 10240 cells in
# float32, 5120 in float64) and of the azimuthal ring tiles of theta_sweep
# and fargo_theta (a block holds 512 cells in float32, 256 in float64: 508
# and 252 output cells with one sweep, 504 and 248 with two, and a halo of
# 2 cells a sweep each way): NR = 3 (one active ring), rings of 1 and 7
# cells, NAZ under and over a block, a tile and the shared-memory limit,
# several tiles with a ragged last one.
CFL_SHAPES = ((3, 1), (3, 7), (20, 7), (37, 1030), (6, 255), (6, 257),
              (4, 5120), (4, 5121), (3, 10240), (3, 10241))
THETA_SHAPES = ((3, 1), (3, 7), (20, 7), (37, 1030), (4, 247), (4, 253),
                (4, 503), (4, 509))


def sweep_cfl_tile_edges(device) -> None:
    """cfl, theta_sweep and fargo_theta against their plain versions over
    CFL_SHAPES and THETA_SHAPES on seeded random inputs: cfl with fast
    transport on and off and with a NaN or a zero energy planted in the
    last active ring (dt NaN and 0 in both versions); the sweeps at K = 1,
    2, 5 and 6, both limiters, fargo_theta with one and two sweeps and
    shifts of either sign and beyond one turn. float64 at the rtol of
    KERNELS, float32 at F32_TOL (cfl's dt relative, each plane of a batch
    by its own max)."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    constants = Constants.from_units(Units())
    for dtype in (torch.float64, torch.float32):
        label = str(dtype).removeprefix("torch.")
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa
        worst = {"cfl": 0.0, "theta_sweep": 0.0, "fargo_theta": 0.0}
        for nr, naz in CFL_SHAPES:
            geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
            rng = np.random.default_rng(29)
            raw = [rng.random((nr, naz)) + 0.5,
                   (rng.random((nr + 1, naz)) - 0.5) * 0.05,
                   (rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                   rng.random((nr, naz)) * 1e-3 + 1e-3,
                   rng.random((nr, naz)) * 1e-6, rng.random((nr, naz)) * 1e-6]
            for fast in (True, False):
                ctx = K.KernelContext(
                    Physics(eos="adiabatic", adiabatic_index=1.4,
                            viscous_alpha=1e-3, aspectratio_ref=0.05,
                            artificial_viscosity="sn", fast_transport=fast),
                    constants, geometry, dtype, device)
                for plant in ("none", "nan", "zero_energy"):
                    f = [t(a) for a in raw]
                    if plant == "nan":
                        f[0][nr - 2, naz // 2] = float("nan")
                    elif plant == "zero_energy":
                        f[3][nr - 2, naz - 1] = 0.0
                    got, ref = float(K.cfl(ctx, *f)), float(K.cfl_plain(ctx, *f))
                    want = {"nan": math.isnan(got),
                            "zero_energy": got == 0.0}.get(plant, True)
                    if plant == "none":
                        worst["cfl"] = max(worst["cfl"], abs(got - ref) / ref)
                    np.testing.assert_allclose(
                        got, ref, rtol=F64_RTOL["cfl"] if dtype ==
                        torch.float64 else F32_TOL,
                        err_msg=f"cfl {nr}x{naz} {label} {plant} fast={fast}")
                    if not want:
                        raise AssertionError(f"cfl {nr}x{naz} {label} {plant}"
                                             f": dt = {got}")
        for nr, naz in THETA_SHAPES:
            geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
            for k in (1, 2, 5, 6):
                rng = np.random.default_rng(37)
                qs = t(rng.random((k, nr, naz)) + 0.5)
                v = t((rng.random((nr, naz)) - 0.5) * 0.05)
                vconst = t((rng.random((nr, 1)) - 0.5) * 0.02)
                nshift = torch.tensor(
                    rng.integers(-2 * naz - 3, 2 * naz + 3, nr),
                    dtype=torch.int32, device=device)
                dt = t(0.01)
                for limiter in (0, 1):
                    ctx = K.KernelContext(Physics(flux_limiter_type=limiter),
                                          constants, geometry, dtype, device)
                    pairs = {"theta_sweep": [(K.theta_sweep(ctx, qs, v, dt),
                                              K.theta_sweep_plain(ctx, qs, v,
                                                                  dt))]}
                    pairs["fargo_theta"] = [
                        (K.fargo_theta(ctx, qs, v, vconst, nshift, dt, two),
                         K.fargo_theta_plain(ctx, qs, v, vconst, nshift, dt,
                                             two)) for two in (False, True)]
                    for name, results in pairs.items():
                        for got, ref in results:
                            where = f"{name} {nr}x{naz} {label} K={k} " \
                                f"limiter={limiter}"
                            if dtype == torch.float64:
                                np.testing.assert_allclose(
                                    got.cpu().numpy(), ref.cpu().numpy(),
                                    rtol=F64_RTOL[name],
                                    atol=1e-13 * float(ref.abs().max()),
                                    err_msg=where)
                            for j in range(k):
                                worst[name] = max(worst[name], float(
                                    (got[j] - ref[j]).abs().max()
                                    / ref[j].abs().max()))
        for name, w in worst.items():
            shapes = CFL_SHAPES if name == "cfl" else THETA_SHAPES
            log(f"  {name:20s}  tile edges {shapes} {label}: max|k-p| / "
                f"scale = {w:.3e}")
            if dtype == torch.float32 and not w <= F32_TOL:
                raise AssertionError(f"{name} across its tile edges, "
                                     f"float32: {w:.3e} > {F32_TOL} of scale")


def radial_tile_edges(device) -> None:
    """radial_momenta_sweep and radial_sweep against their plain versions
    over RADIAL_SHAPES (the radial column march: a thread marches up a
    strip of 16 rows, a block holds 128 columns) on seeded random inputs
    with vrad of both signs: radial_momenta_sweep isothermal and adiabatic,
    radial_sweep at K = 1, 2, 5 and 6, both limiters. float64 at the rtol
    of KERNELS, float32 at F32_TOL of each plane's scale."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    constants = Constants.from_units(Units())
    cases = (("radial_momenta_sweep", 5), ("radial_momenta_sweep", 6),
             ("radial_sweep", 1), ("radial_sweep", 2), ("radial_sweep", 5),
             ("radial_sweep", 6))
    for dtype in (torch.float64, torch.float32):
        label = str(dtype).removeprefix("torch.")
        worst = {"radial_momenta_sweep": 0.0, "radial_sweep": 0.0}
        for nr, naz in RADIAL_SHAPES:
            geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
            for name, k in cases:
                f = radial_inputs(nr, naz, k, dtype, device)
                for limiter in (0, 1):
                    ctx = K.KernelContext(
                        Physics(eos="isothermal" if k == 5 else "adiabatic",
                                adiabatic_index=1.4, aspectratio_ref=0.05,
                                flux_limiter_type=limiter),
                        constants, geometry, dtype, device)
                    kern, plain = radial_calls(ctx, f)[name]
                    got, ref = kern(), plain()
                    where = f"{name} {nr}x{naz} {label} K={k} " \
                        f"limiter={limiter}"
                    if dtype == torch.float64:
                        np.testing.assert_allclose(
                            got.cpu().numpy(), ref.cpu().numpy(),
                            rtol=F64_RTOL[name],
                            atol=1e-13 * float(ref.abs().max()),
                            err_msg=where)
                    for j in range(got.shape[0]):
                        worst[name] = max(worst[name], float(
                            (got[j] - ref[j]).abs().max()
                            / ref[j].abs().max()))
        for name, w in worst.items():
            batches = "both EoS" if name == "radial_momenta_sweep" \
                else "K = 1, 2, 5, 6"
            log(f"  {name:20s}  strip edges {len(RADIAL_SHAPES)} shapes "
                f"(NR 3-33 x NAZ 1-129, 37x1030) {label}, {batches}, both "
                f"limiters: max|k-p| / scale = {w:.3e}")
            if dtype == torch.float32 and not w <= F32_TOL:
                raise AssertionError(f"{name} across its strip edges, "
                                     f"float32: {w:.3e} > {F32_TOL} of scale")


def parity_tile_edges(device) -> None:
    """The whole-transport kernel against the plain transport at shapes
    that cross the edges of its tiles (strips of 16 rows; 512 cells of a
    ring a block in float32, 256 in float64, plus a halo of 9): 37x1030
    (NR off a multiple of 16, a last tile of 6 cells) and 20x7 (a ring
    shorter than the halo), seeded random fields, shifts of either sign
    and beyond one turn, K = 5 and 6, both limiters, one and two azimuthal
    sweeps. float64 at the rtol of KERNELS, float32 at F32_TOL of each
    output's scale. Before it the viscous kick and the sources across the
    edges of theirs (``kick_tile_edges``), cfl and the azimuthal sweeps
    across theirs (``sweep_cfl_tile_edges``) and the radial sweeps across
    theirs (``radial_tile_edges``)."""
    kick_tile_edges(device)
    sweep_cfl_tile_edges(device)
    radial_tile_edges(device)
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    constants = Constants.from_units(Units())
    names = ("sigma", "vrad", "vaz", "energy", "mass_flux")
    for nr, naz in ((37, 1030), (20, 7)):
        geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
        rng = np.random.default_rng(17)
        raw = {"sigma": rng.random((nr, naz)) + 0.5,
               "energy": rng.random((nr, naz)) * 1e-3 + 1e-3,
               "vaz": (rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
               "vrad": (rng.random((nr + 1, naz)) - 0.5) * 0.05}
        shifts = rng.integers(-2 * naz, 2 * naz, nr)
        for dtype in (torch.float64, torch.float32):
            f = {k: torch.tensor(v, dtype=dtype, device=device)
                 for k, v in raw.items()}
            dt = torch.tensor(0.01, dtype=dtype, device=device)
            omega = torch.tensor(0.3, dtype=torch.float64, device=device)
            nshift = torch.tensor(shifts, dtype=torch.int32, device=device)
            worst = 0.0
            for eos_name in ("adiabatic", "isothermal"):
                for limiter in (0, 1):
                    for fast in (True, False):
                        ctx = K.KernelContext(
                            Physics(eos=eos_name, adiabatic_index=1.4,
                                    aspectratio_ref=0.05,
                                    flux_limiter_type=limiter,
                                    fast_transport=fast),
                            constants, geometry, dtype, device)
                        vmean, _, vconst = tr.fargo_shift(ctx.g, f["vaz"],
                                                          dt)
                        args = (ctx, f["sigma"], f["vrad"], f["vaz"],
                                f["energy"], omega, dt,
                                (vmean, nshift, vconst))
                        got = K.transport(*args, route="whole")
                        ref = K.transport_plain(*args, route="whole")
                        label = f"transport {nr}x{naz} {eos_name} " \
                            f"limiter={limiter} fast={fast}"
                        if dtype == torch.float64:
                            for oname, a, b in zip(names, got, ref):
                                np.testing.assert_allclose(
                                    a.cpu().numpy(), b.cpu().numpy(),
                                    rtol=F64_RTOL["transport"],
                                    atol=1e-13 * float(b.abs().max()),
                                    err_msg=f"{label} {oname}")
                        for oname, a, b in zip(names, got, ref):
                            scale = float(f["vaz"].abs().max()) \
                                if oname in ("vrad", "vaz") \
                                else float(b.abs().max())
                            worst = max(worst,
                                        float((a - b).abs().max()) / scale)
            log(f"  transport             tile edges {nr}x{naz} "
                f"{str(dtype).removeprefix('torch.')}, K = 5 and 6, both "
                f"limiters, one and two sweeps: max|k-p| / scale = "
                f"{worst:.3e}")
            if dtype == torch.float32 and not worst <= F32_TOL:
                raise AssertionError(f"transport at {nr}x{naz} float32: "
                                     f"{worst:.3e} > {F32_TOL} of scale")


def parity_f32_planet(sim, gpu) -> dict:
    """The whole route's four kernels in their locally isothermal variants
    against their plain versions at 1024x3072 on the perturbed planet_disk
    state (K = 5: no energy plane), the sources with the star and the
    1e-3 planet at r = 1 half way up its mass ramp; the transport launch by
    launch."""
    st, ctx = sim.state, sim.stepper.ops
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    t_mid = 0.5 * float(sim.stepper.body_ramp_time[1])
    bodies = sim.stepper.bodies_on_grid(st.nbody, t_mid)
    frac = float(bodies.mass[1]) / float(st.nbody.mass[1])
    if not abs(frac - 0.5) < 1e-12:
        raise AssertionError(f"the planet's mass half way up its ramp is "
                             f"{frac} of its own")
    log(f"  planet_disk {NR}x{NAZ} float32, isothermal; the planet at "
        f"({float(bodies.x[1]):.4f}, {float(bodies.y[1]):.4f}) with "
        f"{frac:.3f} of its mass (t = {t_mid:.3f})")
    calls = op_calls(ctx, f, (st.qplus, st.qminus), bodies, st.omega_frame,
                     dt)
    out = measure(calls, f, NR)
    out["transport"]["per_launch"] = log_launches(
        "transport (isothermal, K = 5)", calls["transport"][0],
        OP_FRAGMENTS["transport"], 5, nbytes([f["sigma"]]), gpu)
    return out


# the shapes of the reference-binary goldens this port runs: 97x376
# (cold_disk_planet, longrun_planet: odd NR), 256x2 (spreading_ring) and
# 100x2 (shocktube_sn): rings of two cells
GOLDEN_SHAPES = ((97, 376), (256, 2), (100, 2))


def golden_grid_edges(device) -> None:
    """cfl, sources, viscous_kick and the whole-transport kernel against
    their plain versions at GOLDEN_SHAPES on seeded random fields, both
    dtypes, the goldens' variants: isothermal without artificial viscosity
    (the spreading ring), adiabatic SN (the shock tube), adiabatic TW
    (the cold disk), a star and a planet. float64 at the rtol of KERNELS,
    float32 at F32_TOL of each output's scale."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops.gravity import BodiesOnGrid
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    constants = Constants.from_units(Units())
    variants = (("isothermal", "none"), ("adiabatic", "sn"),
                ("adiabatic", "tw"))
    for dtype in (torch.float64, torch.float32):
        label = str(dtype).removeprefix("torch.")
        worst = dict.fromkeys(("cfl", "sources", "viscous_kick",
                               "transport"), 0.0)
        for nr, naz in GOLDEN_SHAPES:
            geometry = Geometry.build(nr, naz, 0.4, 2.0, "Log")
            rng = np.random.default_rng(41)
            raw = {"sigma": rng.random((nr, naz)) + 0.5,
                   "energy": rng.random((nr, naz)) * 1e-3 + 1e-3,
                   "vaz": (rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                   "vrad": (rng.random((nr + 1, naz)) - 0.5) * 0.05}
            t = lambda a, d=dtype: torch.tensor(  # noqa: E731
                a, dtype=d, device=device)
            q = (t(rng.random((nr, naz)) * 1e-6),
                 t(rng.random((nr, naz)) * 1e-6))
            bodies = BodiesOnGrid(
                x=t([0.0, 1.0], torch.float64), y=t([0.0, 0.2],
                                                    torch.float64),
                mass=t([1.0, 5e-4], torch.float64),
                cubic_smoothing_radius=t([0.0, 0.05], torch.float64))
            for eos_name, artvisc in variants:
                f = {k: t(v) for k, v in raw.items()}
                if eos_name == "isothermal":
                    f["energy"] = torch.zeros_like(f["energy"])
                ctx = K.KernelContext(
                    Physics(eos=eos_name, adiabatic_index=1.4,
                            viscous_alpha=1e-3, aspectratio_ref=0.05,
                            flaring_index=0.25, artificial_viscosity=artvisc,
                            heating_viscous=True, cooling_beta_enabled=True,
                            cooling_beta=10.0, minimum_temperature=1e-6,
                            sigma0=1.0, sigma_floor=1e-6,
                            thickness_smoothing=0.6),
                    constants, geometry, dtype, device)
                calls = op_calls(ctx, f, q if eos_name == "adiabatic" else
                                 (torch.zeros_like(q[0]),) * 2, bodies,
                                 t(0.0, torch.float64), t(0.003))
                for name, (kern, plain, names, _) in calls.items():
                    got, ref = kern(), plain()
                    for oname, a, b in zip(names, got, ref):
                        where = f"{name} {nr}x{naz} {label} {eos_name} " \
                            f"{artvisc} {oname}"
                        scale = float(b.abs().max())
                        if oname in ("vrad", "vaz"):
                            scale = max(scale, float(f["vaz"].abs().max()))
                        err = float((a - b).abs().max())
                        if dtype == torch.float64:
                            np.testing.assert_allclose(
                                a.cpu().numpy(), b.cpu().numpy(),
                                rtol=F64_RTOL[name], atol=1e-13 * scale,
                                err_msg=where)
                        rel = err / scale if scale > 0.0 else \
                            (0.0 if err == 0.0 else math.inf)
                        worst[name] = max(worst[name], rel)
        for name, w in worst.items():
            log(f"  {name:20s}  the goldens' grids {GOLDEN_SHAPES} {label}, "
                f"isothermal, SN, TW: max|k-p| / scale = {w:.3e}")
            if dtype == torch.float32 and not w <= F32_TOL:
                raise AssertionError(f"{name} at the goldens' grids, "
                                     f"float32: {w:.3e} > {F32_TOL}")


def ias15_bodies(case, device):
    """(x, y, vx, vy, m) float64 on ``device`` and a period: two bodies at
    apocentre at e = 0.9, or a star and three planets from a seed."""
    if case == "2 bodies, e = 0.9":
        e, m2 = 0.9, 1e-3
        m = np.array([1.0, m2])
        big = m.sum()
        r, v = 1 + e, np.sqrt(big * (1 - e) / (1 + e))
        arrs = (np.array([-(m2 / big) * r, r / big]), np.zeros(2),
                np.zeros(2), np.array([-(m2 / big) * v, v / big]), m)
        period = 2 * np.pi / np.sqrt(big)
    else:
        rng = np.random.default_rng(5)
        a = np.array([0.7, 1.3, 2.1])
        phi = rng.random(3) * 2 * np.pi
        vk = np.sqrt(1.0 / a) * (1.0 + 0.1 * rng.random(3))
        arrs = (np.concatenate([[0.0], a * np.cos(phi)]),
                np.concatenate([[0.0], a * np.sin(phi)]),
                np.concatenate([[0.0], -vk * np.sin(phi)]),
                np.concatenate([[0.0], vk * np.cos(phi)]),
                np.array([1.0, 1e-3, 3e-4, 2e-3]))
        period = 2 * np.pi * 0.7 ** 1.5
    return [torch.tensor(x, dtype=torch.float64, device=device)
            for x in arrs], period


def cuda_kernel_launches(fn) -> int:
    """The device kernels one call of ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # the spans' device-side annotations (``fc:``) are not kernels
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy" not in e.name and "Memset" not in e.name
               and not e.name.startswith("fc:"))


# the cold float64 PVTE refresh against its plain version: gamma_eff and mu
# at rtol 1e-13, gamma1 at 1e-10 (tests/test_torch_pvte.py's tolerances:
# gamma1's finite differences with eps = 1e-4 scale the rounding by 1e4)
PVTE_RTOL = {"gamma_eff": 1e-13, "mu": 1e-13, "gamma1": 1e-10}


def pvte_refresh_parity(gpu) -> dict:
    """pvte_refresh against its plain version on the PDS70 gas state in
    float64 at NR x NAZ with seeded noise (the benchmark's PVTE disk): each
    output's largest relative difference and the number of values that
    differ at all, the kernel's and the plain version's ms a call by
    events, the kernel's device time, the plain version's device launches,
    and the least time: 3 planes in and 3 out at the memory rate against
    the plain version's operations at the float64 rate."""
    from fargocpt_torch.ops import kernels as K
    t0 = time.perf_counter()
    sim = pds70_gas(NR, NAZ, "float64", "cuda")
    log(f"  PDS70 gas {NR}x{NAZ} float64 built in "
        f"{time.perf_counter() - t0:.2f} s")
    f = perturbed(sim)
    s, e = f["sigma"], f["energy"]
    h = sim.stepper.pvte_scale_height(s, e)
    pv = sim.stepper.pvte
    kern = partial(K.pvte_refresh, pv, s, e, h)
    plain = partial(K.pvte_refresh_plain, pv, s, e, h)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(PVTE_RTOL, got, ref):
        rel = float(((a - b).abs() / b.abs()).max())
        differ = int((a != b).sum())
        log(f"  pvte_refresh {name:9s} f64 {NR}x{NAZ}: max rel {rel:.3e}, "
            f"{differ} of {a.numel()} values differ (rtol "
            f"{PVTE_RTOL[name]:.0e})")
        if not rel <= PVTE_RTOL[name]:
            raise AssertionError(f"pvte_refresh.{name}: kernel/plain "
                                 f"mismatch {rel:.3e}")
        out[f"{name}_max_rel"] = rel
        out[f"{name}_values_differ"] = differ
    ms, plain_ms = time_ms(kern), time_ms(plain)
    # the device time from ten calls back to back between two events: the
    # host enqueues the next call while the card runs one (~0.3 ms of host
    # a call against ~6 ms of kernel), so the card waits only before the
    # first. Here the profiler has kept 6 of 10 and 0 of 1 of this
    # kernel's launches.
    device_ms = time_ms(lambda: [kern() for _ in range(10)], reps=5) / 10
    plain_launches = cuda_kernel_launches(plain)
    flops = flops_of(plain)
    bnd = bound([s, e, h], got, flops, F64_OPS_PER_S)
    log(f"  pvte_refresh         kernel {ms:.4f} ms (device {device_ms:.4f})"
        f"   plain {plain_ms:.4f} ms ({plain_launches} device launches)   "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {flops} flops = "
        f"{flops / (NR * NAZ):.1f} per cell) [{gpu}]")
    return {"max_abs_err": max(float((a - r).abs().max())
                               for a, r in zip(got, ref)),
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, **bnd,
            "plain_launches": plain_launches, "library_ms": None, **out}


def bodies_on_grid_parity(gpu) -> dict:
    """bodies_on_grid against its plain version on the card, bit for bit,
    for 3 bodies (PDS 70 and its two planets, a ramp in progress, cubic
    smoothing on) and for 513: the kernel's and the plain version's ms a
    call by events, the plain version's device launches and the least
    time (bytes in and out at the memory rate against the plain version's
    operations at the float64 rate); the 3 bodies' numbers are reported."""
    from fargocpt_torch.nbody.system import NBodyState
    from fargocpt_torch.ops import kernels as K
    dev = torch.device("cuda")
    res = {}
    for n in (513, 3):
        rng = np.random.default_rng(n)
        a = np.concatenate([[0.0], 0.5 + 2.0 * rng.random(n - 1)])
        phi = rng.random(n) * 2 * np.pi
        m = np.concatenate([[0.76], 10.0 ** rng.uniform(-6, -2, n - 1)])
        z = np.zeros(n)
        nb = NBodyState(*(torch.tensor(v, dtype=torch.float64, device=dev)
                          for v in (a * np.cos(phi), a * np.sin(phi), z, z,
                                    m)))
        ramp = torch.tensor(np.linspace(0.0, 3.0, n), dtype=torch.float64,
                            device=dev)
        factor = torch.full((n,), 0.2, dtype=torch.float64, device=dev)
        t = torch.tensor(1.25, dtype=torch.float64, device=dev)
        kern = partial(K.bodies_on_grid, nb, ramp, factor, t)
        plain = partial(K.bodies_on_grid_plain, nb, ramp, factor, t)
        got, ref = kern(), plain()
        for name, a_, b_ in zip(("mass", "roche", "cubic"), got, ref):
            if not torch.equal(a_, b_):
                raise AssertionError(f"bodies_on_grid.{name} ({n} bodies): "
                                     "kernel and plain differ")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        device_ms = time_ms(lambda: [kern() for _ in range(10)],
                            reps=5) / 10
        plain_launches = cuda_kernel_launches(plain)
        flops = flops_of(plain)
        bnd = bound([nb.x, nb.y, nb.mass, ramp, factor, t.reshape(1)], got,
                    flops, F64_OPS_PER_S)
        log(f"  bodies_on_grid {n} bodies: bit for bit; kernel {ms:.4f} ms "
            f"(device {device_ms:.4f})   plain {plain_ms:.4f} ms "
            f"({plain_launches} device launches)   bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {flops} flops) "
            f"[{gpu}]")
        res = {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
               "plain_ms": plain_ms, **bnd, "plain_launches": plain_launches,
               "library_ms": None, "bodies": n}
    return res


def ias15_parity(sim, gpu) -> dict:
    """The ias15 kernel against its plain version on the card in float64:
    two bodies at e = 0.9 and four bodies over a period in calls of a
    tenth of it (the same accepted substeps and trial steps; the state to
    1e-13 of its scale), each one's ms a call, kernel and plain by CUDA
    events, and the plain version's device launches a call; then both on
    the planet_disk's bodies and step dt (the main path's inputs), whose
    numbers the kernels line reports."""
    from fargocpt_torch.ops import kernels as K
    dev = torch.device("cuda")
    res = {}
    cases = {c: ias15_bodies(c, dev) for c in ("2 bodies, e = 0.9",
                                               "4 bodies")}
    nb = sim.state.nbody
    cases["planet_disk"] = ([nb.x, nb.y, nb.vx, nb.vy, nb.mass], None)
    dt_step = sim.stepper.cfl_dt(sim.state)
    # what one launch costs by events: PyTorch's fill of one value
    one = torch.zeros(1, dtype=torch.float64, device=dev)
    res["one_launch_ms"] = time_ms(one.zero_)
    log(f"  one launch (a fill of one value) by events: "
        f"{res['one_launch_ms']:.4f} ms [{gpu}]")
    for case, ((x, y, vx, vy, m), period) in cases.items():
        dt = dt_step if period is None else torch.tensor(
            period / 10, dtype=torch.float64, device=dev)
        G = sim.constants.G if period is None else 1.0
        ks = ps = (x, y, vx, vy)
        max_abs, steps = 0.0, []
        for _ in range(10 if period is not None else 1):
            counts = torch.zeros(2, dtype=torch.int32, device=dev)
            ks = K.ias15(*ks, m, G, dt, counts=counts)
            pc = []
            ps = K.ias15_plain(*ps, m, G, dt, pc)
            got = tuple(counts.tolist())
            if got != pc[0]:
                raise AssertionError(f"ias15 {case}: the kernel took {got} "
                                     f"(accepted, trials), plain {pc[0]}")
            steps.append(got)
            for group in ((0, 1), (2, 3)):
                scale = max(float(ps[i].abs().max()) for i in group)
                for i in group:
                    err = float((ks[i] - ps[i]).abs().max())
                    max_abs = max(max_abs, err)
                    if not err <= F64_RTOL["ias15"] * scale:
                        raise AssertionError(
                            f"ias15 {case}: kernel and plain differ by "
                            f"{err:.3e} (scale {scale:.3e})")
        args = (x, y, vx, vy, m, G, dt)
        ms = time_ms(lambda: K.ias15(*args))
        plain_ms = time_ms(lambda: K.ias15_plain(*args))
        plain_launches = cuda_kernel_launches(lambda: K.ias15_plain(*args))
        flops = flops_of(lambda: K.ias15_plain(*args))
        outs = K.ias15(*args)
        b = bound([x, y, vx, vy, m, dt.reshape(1)], outs, flops,
                  F64_OPS_PER_S)
        log(f"  ias15 {case}: {len(steps)} calls, (accepted substeps, "
            f"trial steps) {steps} in both, max|k-p| {max_abs:.3e}; one "
            f"call: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"({plain_launches} device launches), bound {b['bound_ms']:.2e} "
            f"ms ({b['bound_by']}; {flops} float64 flops) [{gpu}]")
        res[case] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     **b, "library_ms": None,
                     "plain_launches": plain_launches, "steps": steps}
    return res


def many_bodies(n, device):
    """A star and n - 1 small planets on near-circular orbits between r =
    0.6 and 2.4, from a seed: (x, y, vx, vy, m) float64 and the innermost
    period (tests/test_torch_gpu.py's)."""
    rng = np.random.default_rng(n)
    a = np.linspace(0.6, 2.4, n - 1)
    phi = rng.random(n - 1) * 2 * np.pi
    vk = np.sqrt(1.0 / a) * (1.0 + 0.02 * rng.random(n - 1))
    arrs = (np.concatenate([[0.0], a * np.cos(phi)]),
            np.concatenate([[0.0], a * np.sin(phi)]),
            np.concatenate([[0.0], -vk * np.sin(phi)]),
            np.concatenate([[0.0], vk * np.cos(phi)]),
            np.concatenate([[1.0], 1e-4 * (1.0 + rng.random(n - 1))]))
    return [torch.tensor(v, dtype=torch.float64, device=device)
            for v in arrs], 2 * np.pi * 0.6 ** 1.5


def parity_leapfrog(sim, gpu) -> dict:
    """The leapfrog's kernel interfaces against their plain versions:
    sources with a smoothing plane and viscous_kick with its in-kick sound
    speed at 1024x3072 float32 on the perturbed flagship state, each timed
    with its bound counting the extra plane; sources with 513 bodies (two
    chunks of its table), float32 there and float64 at 130x200; ias15 with
    17 and 40 bodies bit for bit with the same counts, and its ms a call at
    17 beside the plain version's."""
    from fargocpt_torch.ops import gravity
    from fargocpt_torch.ops import kernels as K
    st, ctx = sim.state, sim.stepper.ops
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    zero = torch.zeros((), dtype=torch.float64, device=s.device)
    gen = torch.Generator(device=s.device).manual_seed(11)
    h_smooth = sim.stepper.derived(s, e)[2] * (
        1.0 + 1e-2 * torch.rand(s.shape, generator=gen, device=s.device))
    cell_x, cell_y = ctx.cell_xy()
    planets = gravity.BodiesOnGrid(
        x=torch.tensor([0.0, 1.0, -0.4], dtype=torch.float64,
                       device=s.device),
        y=torch.tensor([0.0, 0.3, 1.1], dtype=torch.float64,
                       device=s.device),
        mass=torch.tensor([1.0, 1e-3, 3e-4], dtype=torch.float64,
                          device=s.device),
        cubic_smoothing_radius=torch.tensor([0.0, 0.1, 0.05],
                                            dtype=torch.float64,
                                            device=s.device))
    fields = [s, vr, va, e, ctx.cols]
    calls = {
        "sources_h_smooth": (
            lambda: K.sources(ctx, s, vr, va, e, planets, (zero, zero),
                              st.omega_frame, dt, h_smooth=h_smooth),
            lambda: K.sources_plain(ctx, s, vr, va, e, planets,
                                    (zero, zero), st.omega_frame, dt,
                                    h_smooth=h_smooth),
            ("vrad", "vaz"),
            fields + [ctx.cos_row, ctx.sin_row, h_smooth]),
        "viscous_kick_cs": (
            lambda: K.viscous_kick(ctx, s, vr, va, e, dt, 0.0, want_cs=True),
            lambda: K.viscous_kick_plain(ctx, s, vr, va, e, dt, 0.0,
                                         want_cs=True),
            ("vrad", "vaz", "energy", "qplus", "qminus", "cs"), fields),
    }
    plain_without = K.sources_plain(ctx, s, vr, va, e, planets, (zero, zero),
                                    st.omega_frame, dt)
    if all(torch.equal(a, b) for a, b in
           zip(calls["sources_h_smooth"][1](), plain_without)):
        raise AssertionError("sources: the smoothing plane changed nothing")
    out = measure(calls, f, NR)

    # 513 bodies: float32 at full size, float64 at 130x200
    (x, y, _, _, m), _ = many_bodies(513, s.device)
    crowd = gravity.BodiesOnGrid(x=x, y=y, mass=m,
                                 cubic_smoothing_radius=torch.full_like(
                                     m, 0.05) * (m < 1.0))
    kern = lambda: K.sources(ctx, s, vr, va, e, crowd,  # noqa: E731
                             (zero, zero), st.omega_frame, dt)
    got, ref = kern(), K.sources_plain(ctx, s, vr, va, e, crowd,
                                       (zero, zero), st.omega_frame, dt)
    err = check_f32("sources", got, ref, ("vrad", "vaz"), f, NR)
    ms = time_ms(kern, reps=5)
    log(f"  sources with 513 bodies, {NR}x{NAZ} float32: max|k-p| "
        f"{err:.3e}, kernel {ms:.4f} ms [{gpu}]")
    out["sources_513_bodies"] = {"max_abs_err": err, "ms": ms}
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.units import Units
    ctx64 = K.KernelContext(sim.phys, Constants.from_units(Units()),
                            Geometry.build(130, 200, 0.4, 2.5, "Log"),
                            torch.float64, s.device)
    rng = np.random.default_rng(5)
    t64 = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                                 device=s.device)
    a64 = (t64(rng.random((130, 200)) + 0.5),
           t64((rng.random((131, 200)) - 0.5) * 0.05),
           t64((rng.random((130, 200)) - 0.5) * 0.1 + 1.0),
           t64(rng.random((130, 200)) * 1e-3 + 1e-3))
    rest = (crowd, (zero, zero), t64(0.4), t64(0.003))
    got, ref = K.sources(ctx64, *a64, *rest), K.sources_plain(ctx64, *a64,
                                                              *rest)
    for g, r in zip(got, ref):
        if not torch.allclose(g, r, rtol=F64_RTOL["sources"], atol=1e-13):
            raise AssertionError("sources, 513 bodies, float64: kernel and "
                                 "plain differ by "
                                 f"{float((g - r).abs().max()):.3e}")

    # ias15 beyond the thread's own arrays
    for n in (17, 40):
        (x, y, vx, vy, m), period = many_bodies(n, s.device)
        dt_n = torch.tensor(period / 20, dtype=torch.float64,
                            device=s.device)
        ks = ps = (x, y, vx, vy)
        steps = []
        for _ in range(3):
            counts = torch.zeros(2, dtype=torch.int32, device=s.device)
            ks = K.ias15(*ks, m, 1.0, dt_n, counts=counts)
            pc = []
            ps = K.ias15_plain(*ps, m, 1.0, dt_n, pc)
            if tuple(counts.tolist()) != pc[0]:
                raise AssertionError(f"ias15 {n} bodies: the kernel took "
                                     f"{tuple(counts.tolist())}, plain "
                                     f"{pc[0]}")
            steps.append(pc[0])
            diff = max(float((a - b).abs().max()) for a, b in zip(ks, ps))
            if diff != 0.0:
                raise AssertionError(f"ias15 {n} bodies: kernel and plain "
                                     f"differ by {diff:.3e}")
        entry = {"steps": steps, "max_abs_err": 0.0}
        if n == 17:
            args = (x, y, vx, vy, m, 1.0, dt_n)
            entry["ms"] = time_ms(lambda: K.ias15(*args), reps=10)
            entry["plain_ms"] = time_ms(lambda: K.ias15_plain(*args), reps=3)
        log(f"  ias15 {n} bodies: 3 calls of {period / 20:.4f}, (accepted, "
            f"trials) {steps} in both, bit for bit"
            + (f"; one call: kernel {entry['ms']:.4f} ms, plain "
               f"{entry['plain_ms']:.4f} ms" if n == 17 else "")
            + f" [{gpu}]")
        out[f"ias15_{n}_bodies"] = entry
    return out


# --- phase 3 -----------------------------------------------------------------

def run_slice(sim, warmup=10, steps=60) -> dict:
    """The flagship's steps on its route, with the launch counters set to 0
    just before and read just after: every op of the route its launches a
    step (ROUTE_OPS), cfl, sources and viscous_kick once a step
    (FLAGSHIP_OPS), the other routes' ops, artvisc_sn, ias15 and
    bodies_on_grid (a lone star) and pvte_refresh never."""
    from fargocpt_torch.ops import kernels as K
    route = sim.stepper.ops.route
    nr = sim.geometry.nrad
    telemetry.reset("launch.")
    for _ in range(warmup):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    t_start = sim.time.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = telemetry.values("launch.", K.OPS)
    n = warmup + steps
    own = ROUTE_OPS[route]
    other = {op for ops in ROUTE_OPS.values() for op in ops} - set(own)
    for name in K.OPS:
        if name in own:
            ok = launches[name] == own[name] * n
        elif name in other or name in ("artvisc_sn", "ias15",
                                       "pvte_refresh", "bodies_on_grid"):
            ok = launches[name] == 0
        else:
            ok = launches[name] == FLAGSHIP_OPS[name] * n
        if not ok:
            raise AssertionError(f"{route} route at {nr} rings launched "
                                 f"{name} {launches[name]} times in {n} "
                                 "steps")
    check_state(sim)
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps
    return {"route": route, "launches": launches, "seconds": seconds,
            "per_step": per_step, "mcell": nr * NAZ / per_step / 1e6,
            "mean_dt": mean_dt,
            "s_per_orbit": 2.0 * math.pi / mean_dt * per_step}


PDS70_OPS = ("transport", "artvisc_sn")
# the flagship's fused substeps a step, whatever the route
FLAGSHIP_OPS = {"cfl": 1, "sources": 1, "viscous_kick": 1}


def check_state(sim) -> None:
    from fargocpt_torch.sim import reachable_tensors
    f = sim.fields
    for name in ("sigma", "vrad", "vaz", "energy"):
        if not bool(torch.isfinite(getattr(f, name)).all()):
            raise AssertionError(f"{name} is not finite")
    if not bool((f.sigma > 0).all()):
        raise AssertionError("sigma <= 0 somewhere")
    on_cpu = [p for p, tsr in reachable_tensors(sim)
              if tsr.device.type != "cuda"]
    if on_cpu:
        raise AssertionError(f"tensors left on the CPU: {on_cpu[:10]}")


def check_pds70_launches(launches, steps, refreshes) -> None:
    """One transport and one artvisc_sn launch a step, one pvte_refresh
    launch a PVTE refresh (``refreshes``: the float64 ones), no other
    kernel."""
    for name, n in launches.items():
        want = steps if name in PDS70_OPS \
            else refreshes if name == "pvte_refresh" else 0
        if n != want:
            raise AssertionError(f"PDS70: kernel {name} launched {n} times "
                                 f"in {steps} steps, expected {want}")


class DustTimer:
    """CUDA events around every call of the stepper's dust integration:
    ``ms()`` is the time between them, summed over the calls so far (the
    device's time in the dust, its waits for the host included)."""

    def __init__(self, stepper):
        self.stepper = stepper
        self.pairs = []
        inner = stepper._integrate_particles

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = inner(*args, **kwargs)
            b.record()
            self.pairs.append((a, b))
            return out
        stepper._integrate_particles = timed

    def ms(self) -> float:
        torch.cuda.synchronize()
        total = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs.clear()
        return total

    def remove(self) -> None:
        del self.stepper._integrate_particles


def run_pds70(sim, warmup=3, steps=10, run_steps=10) -> dict:
    """The PDS70 steps (the gas setup, or the whole setup with its dust)
    through calculate_time_step + step_once, then through the run path
    (advance_to to a time about ``run_steps`` steps ahead), each with the
    launch counters set to 0 just before and read just after. With the
    dust: its share of each window by CUDA events, and the particles alive
    at the end."""
    from fargocpt_torch.ops import kernels as K
    st = sim.stepper
    nr, naz = sim.geometry.nrad, sim.geometry.naz
    dusty = sim.state.particles is not None
    sg0 = telemetry.value("selfgravity.rebuild")
    for _ in range(warmup):
        sim.step_once(sim.calculate_time_step())
    timer = DustTimer(st) if dusty else None
    torch.cuda.synchronize()
    telemetry.reset("launch.")
    fld0, pv0 = (telemetry.value("fld.sor_iterations"),
                telemetry.value("pvte.refresh"))
    t_start = sim.time.clone()
    window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    window[0].record()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    window[1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = telemetry.values("launch.", K.OPS)
    f64 = sim.dtype == torch.float64
    check_pds70_launches(launches, steps,
                         telemetry.value("pvte.refresh") - pv0 if f64 else 0)
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps
    res = {"dtype": str(sim.dtype).removeprefix("torch."),
           "launches": launches, "seconds": seconds, "per_step": per_step,
           "mcell": nr * naz / per_step / 1e6, "mean_dt": mean_dt,
           "s_per_orbit": 2.0 * math.pi / mean_dt * per_step,
           "fld_iterations_per_step":
               (telemetry.value("fld.sor_iterations") - fld0) / steps,
           "pvte_refreshes_per_step":
               (telemetry.value("pvte.refresh") - pv0) / steps,
           "sg_kernel_rebuilds":
               telemetry.value("selfgravity.rebuild") - sg0}
    if dusty:
        res["dust_ms_per_step"] = timer.ms() / steps
        res["dust_share"] = res["dust_ms_per_step"] * steps \
            / window[0].elapsed_time(window[1])

    # the run path: each step's CFL refresh serves its step
    telemetry.reset("launch.")
    fld0, pv0 = (telemetry.value("fld.sor_iterations"),
                telemetry.value("pvte.refresh"))
    target = sim.time + run_steps * mean_dt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, time_, last_dt, n, *_ = st.advance_to(sim.state, sim.time,
                                                 sim.last_dt, target)
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - t0
    sim.state, sim.time, sim.last_dt = state, time_, last_dt
    sim.n_hydro_iter += n
    check_pds70_launches(telemetry.values("launch.", K.OPS), n,
                         telemetry.value("pvte.refresh") - pv0 if f64 else 0)
    res.update({"run_steps": n, "run_per_step": run_seconds / n,
                "run_mcell": nr * naz / (run_seconds / n) / 1e6,
                "run_fld_iterations_per_step":
                    (telemetry.value("fld.sor_iterations") - fld0) / n,
                "run_pvte_refreshes_per_step":
                    (telemetry.value("pvte.refresh") - pv0) / n})
    if res["pvte_refreshes_per_step"] != 3.0 \
            or res["run_pvte_refreshes_per_step"] != 2.0:
        raise AssertionError(
            f"PVTE refreshes per step {res['pvte_refreshes_per_step']} "
            f"(step), {res['run_pvte_refreshes_per_step']} (run path); "
            "expected 3 and 2")
    if dusty:
        res["run_dust_ms_per_step"] = timer.ms() / n
        timer.remove()
        p = sim.state.particles
        res["particles"] = p.n
        res["alive"] = int(p.alive.sum())
        for name in ("r", "phi", "r_dot", "phi_dot", "stokes"):
            if not bool(torch.isfinite(getattr(p, name)).all()):
                raise AssertionError(f"particles.{name} is not finite")
        # float32 with the setup's units (au, solar mass): pi m0 ~ 6e-57
        # rounds to 0 and the stopping time is NaN, so the swarm fails the
        # escape test on its first step and stays frozen, as in the JAX
        # package (tests/test_torch_dust.py); float64 keeps it alive
        if p.r.dtype == torch.float64 and not res["alive"] > 0:
            raise AssertionError("no particle left alive")
    check_state(sim)
    return res


def log_pds70(res, gpu) -> None:
    label = f"PDS70 with {res['particles']} particles" \
        if "particles" in res else "PDS70 gas"
    dtype = res.get("dtype", "float32")
    log(f"  launches {res['launches']}")
    log(f"  {label} {NR}x{NAZ} {dtype}, calculate_time_step + step_once: "
        f"{res['per_step'] * 1e3:.4f} ms/step, {res['mcell']:.2f} "
        f"Mcell-updates/s, mean dt {res['mean_dt']:.4e}, "
        f"{res['s_per_orbit']:.2f} s per orbit at r = 1; FLD "
        f"{res['fld_iterations_per_step']:.2f} SOR iterations/step, PVTE "
        f"{res['pvte_refreshes_per_step']:.2f} refreshes/step [{gpu}]")
    log(f"  {label} {NR}x{NAZ} {dtype}, run path (advance_to, "
        f"{res['run_steps']} steps): {res['run_per_step'] * 1e3:.4f} "
        f"ms/step, {res['run_mcell']:.2f} Mcell-updates/s; FLD "
        f"{res['run_fld_iterations_per_step']:.2f} SOR iterations/step, "
        f"PVTE {res['run_pvte_refreshes_per_step']:.2f} refreshes/step; "
        f"self-gravity kernel rebuilds so far "
        f"{res['sg_kernel_rebuilds']} [{gpu}]")
    if "particles" in res:
        log(f"  the dust, by CUDA events around its call: "
            f"{res['dust_ms_per_step']:.4f} ms/step, "
            f"{100 * res['dust_share']:.2f}% of the timed steps' device "
            f"span; run path {res['run_dust_ms_per_step']:.4f} ms/step; "
            f"{res['alive']} of {res['particles']} particles alive "
            f"[{gpu}]")


def log_slice(res, nr, gpu) -> None:
    log(f"  {res['route']} route, launches {res['launches']}")
    log(f"  {nr}x{NAZ} float32: {res['per_step'] * 1e3:.4f} ms/step "
        f"(CFL + step), {res['mcell']:.1f} Mcell-updates/s, mean dt "
        f"{res['mean_dt']:.4e}, {res['s_per_orbit']:.2f} s per orbit at "
        f"r = 1 [{gpu}]")


# the planet_disk step's kernels and their launches a step: ias15 twice
# (the indirect term's predictor and the drift), bodies_on_grid once (the
# step's start; a swarm adds its own)
PLANET_OPS = {"cfl": 1, "sources": 1, "viscous_kick": 1, "transport": 1,
              "ias15": 2, "bodies_on_grid": 1}
# the planet_torque's leapfrog step: the two kicks' sources and viscous
# kick, ias15 and bodies_on_grid four times (two half drifts, two
# predictors)
PLANET_TORQUE_OPS = {"cfl": 1, "sources": 2, "viscous_kick": 2,
                     "transport": 1, "ias15": 4, "bodies_on_grid": 4}
# the planet_accretion's leapfrog step: sources once (the first kick
# reads the pressure from before the accretion and takes the unfused
# substep, the second kick the kernel), the rest as the planet_torque's
PLANET_ACCRETION_OPS = {"cfl": 1, "sources": 1, "viscous_kick": 2,
                        "transport": 1, "ias15": 4, "bodies_on_grid": 7}
# the binary_gcfull's leapfrog step: AspectRatioMode 1 turns the sources
# and cfl kernels off, AlphaMode 2, StabilizeViscosity 1 and the
# irradiation the viscous kick (step.gates, as the JAX package's gates):
# the whole-transport kernel once, ias15 four times (two bodies),
# bodies_on_grid seven times (the CFL's viscosity among them)
BINARY_OPS = {"transport": 1, "ias15": 4, "bodies_on_grid": 7}
# setups/gamma_cephei_full.yml's own grid
NR_BINARY, NAZ_BINARY = 1609, 1160
# OY_Car's Euler step (an ideal gas with thermal surface cooling: the
# viscous kick's gate is off, the Stone-Norman substep its kernel): cfl,
# sources, artvisc_sn and the whole-transport kernel once, ias15 twice (the
# indirect term's predictor and the drift); V1504 Cyg's leapfrog under
# PVTE and the circumbinary menu: the transport once, ias15 four times,
# pvte_refresh five times (calculate_time_step's refresh and the leapfrog's
# four)
OY_CAR_OPS = {"cfl": 1, "sources": 1, "artvisc_sn": 1, "transport": 1,
              "ias15": 2, "bodies_on_grid": 1}
V1504CYG_OPS = {"transport": 1, "ias15": 4, "pvte_refresh": 5,
                "bodies_on_grid": 5}
# the planet in a self-gravitating disk: the Bessel mode keeps cfl, sources
# and the viscous kick off (step.gates, as the JAX package's), the
# Stone-Norman substep takes its kernel; ias15 twice (the Euler step)
PLANET_SG_OPS = {"artvisc_sn": 1, "transport": 1, "ias15": 2,
                 "bodies_on_grid": 1}
# examples/full_physics.yml: symmetric self-gravity keeps the fused cfl and
# sources, surface cooling keeps the viscous kick off; one star, no ias15
FULL_PHYSICS_OPS = {"cfl": 1, "sources": 1, "artvisc_sn": 1,
                    "transport": 1}
# its own grid; float64, since in float32 its swarm dies on its first step
# in both packages (PDS70's units, au and solar masses: ROADMAP C)
NR_FULL, NAZ_FULL = 128, 256
# the two setups' own grids; both run in float64 (in float32 their
# initial Q+ / Q- are NaN in the JAX package and in the port: the
# radiative correction factor overflows at their units,
# tests/test_torch_cv_f32.py)
NR_OY_CAR, NAZ_OY_CAR = 200, 200
NR_V1504, NAZ_V1504 = 450, 1070
# V1504 Cyg's CFL dt (~1e-17 at 64x128; ROADMAP C) moves no field, so its
# trajectory steps on this fixed dt, under the FARGO shear limit (~4e-3)
V1504_DT = 1e-4


def launch_count_ok(name, got, want) -> bool:
    """A command line's launches of ``name`` against ``want`` for its steps:
    equal, but for bodies_on_grid at least as many, since the monitor rows
    (the bodies' torques and Roche-lobe masses, the set-up's first row)
    launch it as well."""
    return got >= want if name == "bodies_on_grid" else got == want


def run_planet(sim, warmup=10, steps=60, profiled=5, ops=None,
               label="planet_disk") -> dict:
    """A planet setup's steps (calculate_time_step + step_once), with the
    launch counters set to 0 just before and read just after: ``ops`` a
    step (PLANET_OPS by default), no other kernel. Then ``profiled`` steps
    under torch.profiler (every device launch and its time: the busy share
    of the wall) and as many with CUDA's sync debug mode counting the host
    reads."""
    ops = PLANET_OPS if ops is None else ops
    import warnings
    from fargocpt_torch.ops import kernels as K
    nr, naz = sim.geometry.nrad, sim.geometry.naz
    telemetry.reset("launch.")
    for _ in range(warmup):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    t_start = sim.time.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = telemetry.values("launch.", K.OPS)
    n = warmup + steps
    for name in K.OPS:
        if launches[name] != ops.get(name, 0) * n:
            raise AssertionError(f"{label} launched {name} "
                                 f"{launches[name]} times in {n} steps")
    check_state(sim)
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            sim.step_once(sim.calculate_time_step())
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("fc:")]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    ours = ("cfl_ring_kernel", "sources_kernel", "vk_tile_kernel", "tr_",
            "ias15_kernel", "artvisc_sn_kernel", "pvte_refresh_kernel")
    own = sum(1 for e in dev if any(f in e.name for f in ours))
    by_kernel = {}
    for e in dev:
        key = next((f for f in ours if f in e.name), "PyTorch ops")
        by_kernel[key] = by_kernel.get(key, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(profiled):
                sim.step_once(sim.calculate_time_step())
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reads = sum(1 for w in caught if "synchroniz" in str(w.message))
    check_state(sim)
    return {"label": label, "grid": f"{nr}x{naz}",
            "dtype": str(sim.dtype).replace("torch.", ""),
            "launches": launches,
            "seconds": seconds, "per_step": per_step,
            "mcell": nr * naz / per_step / 1e6, "mean_dt": mean_dt,
            "s_per_orbit": 2.0 * math.pi / mean_dt * per_step,
            "device_launches_per_step": len(dev) / profiled,
            "pytorch_launches_per_step": (len(dev) - own) / profiled,
            "device_ms_per_step": device_ms / profiled,
            "device_ms_by_kernel_per_step": {
                k: v / profiled for k, v in by_kernel.items()},
            "busy_share": device_ms / 1e3 / wall_profiled,
            "host_reads_per_step": reads / profiled,
            "planet_mass_felt": float(sim.stepper.bodies_on_grid(
                sim.state.nbody, sim.time).mass[1])
            if sim.stepper.n_bodies > 1 else None}


def log_planet(res, gpu) -> None:
    label = res["label"]
    log(f"  {label} launches {res['launches']}")
    log(f"  {label} {res['grid']} {res['dtype']}: "
        f"{res['per_step'] * 1e3:.4f} "
        f"ms/step (CFL + step), {res['mcell']:.1f} Mcell-updates/s, mean dt "
        f"{res['mean_dt']:.4e}, {res['s_per_orbit']:.2f} s per orbit at "
        f"r = 1 [{gpu}]")
    log(f"  {label} a step: {res['device_launches_per_step']:.1f} "
        f"device launches ({res['pytorch_launches_per_step']:.1f} of them "
        f"PyTorch ops), {res['device_ms_per_step']:.4f} ms of device time ("
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    res["device_ms_by_kernel_per_step"].items())
        + f"), busy {100 * res['busy_share']:.1f}% of the wall, "
        f"{res['host_reads_per_step']:.1f} host reads"
        + (f"; the gas feels {res['planet_mass_felt']:.3e} of the planet's "
           "mass" if res["planet_mass_felt"] is not None else "")
        + f" [{gpu}]")


def swarm_summary(sim) -> dict:
    """The swarm's alive count and the spread (standard deviation) of the
    alive particles' radii."""
    p = sim.state.particles
    r = p.r[p.alive].double()
    return {"alive": int(p.alive.sum()), "n": p.n,
            "r_std": float(r.std()) if r.numel() > 1 else 0.0,
            "r_mean": float(r.mean()) if r.numel() else 0.0}


def unfused_sources(sim, gpu) -> dict:
    """The sources substep an accreting step's first kick takes (the
    N-body potential and the source terms as PyTorch ops, on a given
    pressure) against the sources kernel on the same state, the pressure
    the current fields':
    each one's ms a call by CUDA events, its device launches, and the
    largest difference of their v_rad and v_az over v_az's scale."""
    from fargocpt_torch.ops import gravity, kernels as K, sources as src_ops
    st, f = sim.stepper, sim.fields
    phys, g = st.phys, st.g
    bodies = st.bodies_on_grid(sim.state.nbody, sim.time)
    zero = torch.zeros((), dtype=torch.float64, device=f.sigma.device)
    omega = sim.state.omega_frame
    dt = 0.5 * sim.last_dt
    _, press, h = st.derived(f.sigma, f.energy)
    cell_x, cell_y = st.ops.cell_xy()

    def unfused():
        pot = gravity.nbody_potential(phys, st.constants, g, bodies,
                                      st.n_bodies, cell_x, cell_y, h, zero,
                                      zero)
        return src_ops.update_with_sourceterms(
            phys, g, f.sigma, press, pot, f.vrad, f.vaz, f.energy,
            omega.to(f.sigma.dtype), dt)[:2]

    def fused():
        return K.sources(st.ops, f.sigma, f.vrad, f.vaz, f.energy, bodies,
                         (zero, zero), omega, dt)

    scale = float(f.vaz.abs().max())
    diff = max(float((a - b).abs().max()) / scale
               for a, b in zip(unfused(), fused()))
    res = {"unfused_ms": time_ms(unfused), "kernel_ms": time_ms(fused),
           "unfused_launches": cuda_kernel_launches(unfused),
           "kernel_launches": cuda_kernel_launches(fused),
           "max_diff_of_vaz_scale": diff}
    nr, naz = g.nrad, g.naz
    log(f"  {nr}x{naz} float32, the accreting step's unfused sources "
        f"substep: {res['unfused_ms']:.4f} ms a call "
        f"({res['unfused_launches']} device launches), the sources kernel "
        f"on the same state {res['kernel_ms']:.4f} ms "
        f"({res['kernel_launches']} launch); they differ by {diff:.2e} of "
        f"v_az's scale [{gpu}]")
    if not diff < F32_TOL:
        raise AssertionError(f"the unfused sources and the kernel differ "
                             f"by {diff:.3e}")
    return res


def route_turns(sim, order=("split", "whole", "whole", "split"), warmup=5,
                steps=50) -> dict:
    """ms per step of ``sim`` through each transport route of ``order`` in
    turns, in this process. The whole-transport kernel takes any NR: at
    1000 rings it is the route the port took before the split route
    existed."""
    ctx = sim.stepper.ops
    own = ctx.route
    times = {r: [] for r in dict.fromkeys(order)}
    try:
        for r in order:
            ctx.route = r
            for _ in range(warmup):
                sim.step_once(sim.calculate_time_step())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                sim.step_once(sim.calculate_time_step())
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) / steps * 1e3)
    finally:
        ctx.route = own
    return times


def host_sync_cost(sim, steps=20) -> float:
    """Seconds per step that one host read of a device scalar adds (the
    landing test of the host time loop)."""
    def loop(sync):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            dt = sim.calculate_time_step()
            sim.step_once(dt)
            if sync:
                bool(dt > 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps
    a, b, c, d = loop(False), loop(True), loop(True), loop(False)
    return (b + c - a - d) / 2.0


# --- phase 4 -----------------------------------------------------------------

def trajectory(nr, naz, dtype, steps, budget, setup=flagship,
               dt=None) -> dict:
    """The GPU run through the kernels against the CPU run through the
    plain versions on the GPU run's dt sequence: rel-L2 of each field
    (vrad scaled by vaz), of the bodies (their masses and the frame's rate
    where accretion and the corotating frame change them), of the monitor
    grids that are on and, with a swarm, of the particles' r and phi
    (phi's difference taken on the circle), all under ``budget``; in
    float64 the same particles are alive in both. A monitor grid sums
    terms that cancel (the star's potential differenced across a ring, the
    flux of a v_rad near 0), so in float32 it is rounding to a few per
    cent of itself, in the JAX package as in the port: there each grid is
    held to ``F32_GRID_LIMITS``, which needs the planet_accretion setup at
    256x512 for 200 steps. Given ``dt``, both runs step on it (the CFL dts
    still held to each other), and sigma, vaz and the energy must move by
    more than 1e3 ``budget`` of their scales, so that the comparison is
    seen to bite."""
    from fargocpt_torch.state import MONITOR_GRIDS
    t_start = time.perf_counter()
    gpu = setup(nr, naz, dtype, "cuda")
    cpu = setup(nr, naz, dtype, "cpu")
    start = {k: getattr(cpu.fields, k).double().clone()
             for k in ("sigma", "vaz", "energy")}
    grids = [n for n in MONITOR_GRIDS
             if getattr(cpu.state.monitor_acc, n) is not None]
    limits = {}
    if grids and dtype == "float32":
        assert (setup, nr, naz, steps) == (planet_accretion, 256, 512, 200)
        limits = {n: F32_GRID_LIMITS[n] for n in grids
                  if n in F32_GRID_LIMITS}
    for _ in range(steps):
        if dt is None:
            dt_step = gpu.calculate_time_step()
            gpu.step_once(dt_step)
            cpu.step_once(dt_step.cpu())
            continue
        dt_g, dt_c = gpu.calculate_time_step(), cpu.calculate_time_step()
        if not abs(float(dt_g) - float(dt_c)) <= budget * float(dt_c):
            raise AssertionError(f"trajectory {nr}x{naz} {dtype}: CFL dt "
                                 f"{float(dt_g)!r} on the card, "
                                 f"{float(dt_c)!r} on the CPU")
        gpu.step_once(dt)
        cpu.step_once(dt)
    # the locally isothermal energy is 0 throughout: left out
    moved = {k: float(torch.linalg.norm(getattr(cpu.fields, k).double() - v)
                      / torch.linalg.norm(v)) for k, v in start.items()
             if float(torch.linalg.norm(v)) > 0.0}
    log(f"  {setup.__name__} {nr}x{naz} {dtype}: "
        + ("the CFL dt" if dt is None else f"a fixed dt {dt:.0e}")
        + ", the fields moved by (rel-L2) "
        + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
    if dt is not None and not min(moved.values()) > 1e3 * budget:
        raise AssertionError(f"trajectory {nr}x{naz} {dtype}: the fields "
                             f"moved by {moved}, the check cannot bite")
    errs = {}
    vaz_ref = cpu.fields.vaz.double()
    for name in ("sigma", "vrad", "vaz", "energy"):
        a = getattr(gpu.fields, name).double().cpu()
        b = getattr(cpu.fields, name).double()
        scale = torch.linalg.norm(vaz_ref if name == "vrad" else b)
        if float(scale) == 0.0:
            # the locally isothermal energy: zero in both runs
            errs[name] = 0.0 if torch.equal(a, b) else math.inf
            continue
        errs[name] = float(torch.linalg.norm(a - b) / scale)
    if gpu.state.nbody.n > 1:
        a = torch.stack([getattr(gpu.state.nbody, k).cpu()
                         for k in ("x", "y", "vx", "vy")])
        b = torch.stack([getattr(cpu.state.nbody, k)
                         for k in ("x", "y", "vx", "vy")])
        errs["nbody"] = float(torch.linalg.norm(a - b)
                              / torch.linalg.norm(b))
    if gpu.stepper.any_accretion:
        a, b = gpu.state.nbody.mass.cpu(), cpu.state.nbody.mass
        errs["nbody mass"] = float(torch.linalg.norm(a - b)
                                   / torch.linalg.norm(b))
    if gpu.phys.corotating:
        a, b = float(gpu.state.omega_frame), float(cpu.state.omega_frame)
        errs["omega_frame"] = abs(a - b) / abs(b)
    if cpu.state.monitor_acc.rof_mdot is not None:
        a = float(gpu.state.monitor_acc.rof_mdot)
        b = float(cpu.state.monitor_acc.rof_mdot)
        errs["rof_mdot"] = abs(a - b) / abs(b) if b != 0.0 \
            else (0.0 if a == 0.0 else math.inf)
    # the monitor grids that are on, accumulated over the run

    def rel(a, b):
        scale = torch.linalg.norm(b)
        if float(scale) == 0.0:
            return 0.0 if torch.equal(a, b) else math.inf
        return float(torch.linalg.norm(a - b) / scale)
    for name in grids:
        b = getattr(cpu.state.monitor_acc, name).double()
        errs[name] = rel(getattr(gpu.state.monitor_acc, name).double().cpu(),
                         b)
    swarm = ""
    gp, cp = gpu.state.particles, cpu.state.particles
    if gp is not None:
        r, r_ref = gp.r.double().cpu(), cp.r.double()
        errs["dust r"] = float(torch.linalg.norm(r - r_ref)
                               / torch.linalg.norm(r_ref))
        d = torch.remainder(gp.phi.double().cpu() - cp.phi.double() + math.pi,
                            2.0 * math.pi) - math.pi
        errs["dust phi"] = float(torch.linalg.norm(d)
                                 / torch.linalg.norm(cp.phi.double()))
        alive, alive_ref = gp.alive.cpu(), cp.alive
        swarm = f"; alive {int(alive.sum())} of {gp.n} on the GPU, " \
            f"{int(alive_ref.sum())} on the CPU"
        if dtype == "float64" and not (torch.equal(alive, alive_ref)
                                       and bool(alive.any())):
            raise AssertionError(f"trajectory {nr}x{naz} {dtype}: the "
                                 f"swarms differ or died{swarm}")
    log(f"  {setup.__name__} {nr}x{naz} {dtype} {gpu.stepper.ops.route} "
        f"route, {steps} steps "
        f"(t = {float(gpu.time):.4e}, {time.perf_counter() - t_start:.1f} "
        "s): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"  (budget {budget:.0e}"
        + "".join(f"; {k} {v:.3e}" for k, v in limits.items())
        + f"){swarm}")
    for name, err in errs.items():
        limit = limits.get(name, budget)
        if not err < limit:
            raise AssertionError(f"trajectory {nr}x{naz} {dtype}: {name} "
                                 f"rel-L2 {err:.3e} >= {limit}")
    return errs


def binary_f32_trajectory(nr, naz, steps) -> dict:
    """binary_gcfull on the golden's radii: float32 on the card through the
    kernels against float64 on the CPU through the plain versions, on the
    card's dt sequence; each field's rel-L2 under the limits
    ``flagship.BINARY_F32_LIMITS`` takes from the JAX package's own float32
    deviation."""
    from fargocpt_torch.flagship import BINARY_F32_LIMITS
    gpu = binary_gcfull_golden_radii(nr, naz, "float32", "cuda")
    cpu = binary_gcfull_golden_radii(nr, naz, "float64", "cpu")
    for _ in range(steps):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu().double())
    errs = {}
    for name in BINARY_F32_LIMITS:
        a = getattr(gpu.fields, name).double().cpu()
        b = getattr(cpu.fields, name)
        errs[name] = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    log(f"  binary_gcfull {nr}x{naz} float32 on the card against float64 "
        f"on the CPU, {steps} steps (t = {float(gpu.time):.4e}): "
        + ", ".join(f"{k} {v:.3e} (limit {BINARY_F32_LIMITS[k]:.1e})"
                    for k, v in errs.items()))
    for name, err in errs.items():
        if not err <= BINARY_F32_LIMITS[name]:
            raise AssertionError(f"binary_gcfull float32 {name}: rel-L2 "
                                 f"{err:.3e} > {BINARY_F32_LIMITS[name]}")
    return errs


def newton_budget(nr, naz, steps, budget=1e-4) -> dict:
    """The PDS70 gas setup on the GPU with one warm PVTE Newton step
    against three, on the first run's dt sequence."""
    one = pds70_gas(nr, naz, "float32", "cuda")
    three = pds70_gas(nr, naz, "float32", "cuda")
    three.stepper.pvte.n_newton = 3
    for _ in range(steps):
        dt = one.calculate_time_step()
        one.step_once(dt)
        three.step_once(dt)
    errs = {}
    for name in ("sigma", "vrad", "vaz", "energy"):
        a = getattr(one.fields, name).double()
        b = getattr(three.fields, name).double()
        scale = torch.linalg.norm(three.fields.vaz.double() if name == "vrad"
                                  else b)
        errs[name] = float(torch.linalg.norm(a - b) / scale)
    log(f"  PDS70 gas {nr}x{naz} float32, {steps} steps: PVTE n_newton 1 vs "
        "3: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"  (budget {budget:.0e}, warm vs cold)")
    for name, err in errs.items():
        if not err < budget:
            raise AssertionError(f"n_newton 1 vs 3: {name} rel-L2 {err:.3e}"
                                 f" >= {budget}")
    return errs


# --- phase 5 -----------------------------------------------------------------

# examples/adiabatic_disk.yml at the flagship's full size, one monitor
# interval a snapshot; MonitorTimestep 0.15 is ~40 steps from FirstDT 1e-3,
# then ~31 at the CFL limit; BitwiseExactRestarting writes Q+/Q-, which the
# CFL reads, so a restart replays the trajectory bit for bit
CLI_SETUP = {"Nrad": NR, "Naz": NAZ, "Nmonitor": 1, "FirstDT": 1e-3,
             "MonitorTimestep": 0.15, "BitwiseExactRestarting": "yes"}
# the kernels of the flagship on the whole route; the rest stay at 0
CLI_OPS = ("cfl", "sources", "viscous_kick", "transport")


def yaml_setup(src, path, **over) -> str:
    """A copy of the setup file ``src`` at ``path`` with ``over``'s keys."""
    import yaml
    from fargocpt_torch.flagship import setup_file
    with open(path, "w") as f:
        yaml.safe_dump(setup_file(os.path.join(HERE, src), **over), f)
    return str(path)


def compare_runs(dir_a, dir_b, must=()) -> list:
    """tools/compare_output.py --rtol 0 of two output directories: the
    files of the last snapshot, each of which must be OK, those named in
    ``must`` among them."""
    cmp = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "compare_output.py"),
         dir_a, dir_b, "--rtol", "0"], capture_output=True, text=True,
        timeout=300)
    files = [ln.strip() for ln in cmp.stdout.splitlines()
             if ln.startswith("  ")]
    if cmp.returncode != 0 or not files \
            or any(": OK " not in ln for ln in files) \
            or not all(any(ln.startswith(f"{name}: OK") for ln in files)
                       for name in must):
        raise AssertionError(f"restart of {dir_a} not bit for bit:\n"
                             + cmp.stdout)
    return files


def cli_setup(path, n_snapshots) -> str:
    return yaml_setup("examples/adiabatic_disk.yml", path, **CLI_SETUP,
                      Nsnapshots=n_snapshots)


def run_cli(argv) -> float:
    """``python -m fargocpt_torch`` in this process, so the launch counters
    are readable; returns its wall time."""
    from fargocpt_torch.__main__ import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"fargocpt_torch {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def command_line(work, gpu) -> dict:
    """Run A: ``start --dtype float32`` through two snapshots, with the
    launch counters set to 0 just before and read just after (the four
    flagship kernels launched, no other). Run B: one snapshot, then
    ``restart last`` to the second; tools/compare_output.py --rtol 0 holds
    every file of B against A. Then one snapshot write timed alone."""
    from fargocpt_torch import output as out
    from fargocpt_torch.native import AsyncFileWriter
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.sim import Simulation
    if not AsyncFileWriter().is_native:
        raise AssertionError("the native snapshot writer did not build")
    two = cli_setup(os.path.join(work, "two.yml"), 2)
    one = cli_setup(os.path.join(work, "one.yml"), 1)
    dir_a, dir_b = os.path.join(work, "a"), os.path.join(work, "b")
    telemetry.reset("launch.")
    wall_a = run_cli(["start", two, "--dtype", "float32", "-o", dir_a])
    launches = telemetry.values("launch.", K.OPS)
    for name in K.OPS:
        if (launches[name] > 0) != (name in CLI_OPS):
            raise AssertionError(f"the command line launched {name} "
                                 f"{launches[name]} times")
    with open(os.path.join(dir_a, "logs", "log_0.txt")) as f:
        if "snapshot writer: native" not in f.read():
            raise AssertionError("the command line did not use the native "
                                 "snapshot writer")
    wall_b = run_cli(["start", one, "--dtype", "float32", "-o", dir_b])
    wall_r = run_cli(["restart", "last", two, "--dtype", "float32", "-o",
                      dir_b])
    files = compare_runs(dir_a, dir_b)
    rows = np.atleast_2d(np.loadtxt(os.path.join(
        dir_a, "monitor", "timestepLogging.dat")))
    misc = out.load_misc(os.path.join(dir_a, "snapshots", "2"))
    check_state_arrays(dir_a)

    # one snapshot write alone, on a fresh state at the same size
    sim = Simulation.from_file(two, dtype="float32")
    writer = out.OutputWriter(sim, os.path.join(work, "timing"))
    writer.write_snapshot("warm", register=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = writer.write_snapshot("timed", register=False)
    write_s = time.perf_counter() - t0
    writer.close()
    res = {"grid": f"{NR}x{NAZ}", "dtype": "float32",
           "launches": launches,
           "steps_per_interval": [round(w * 1e3 / ms) for w, ms
                                  in zip(rows[:, 3], rows[:, 4])],
           "hydro_steps": misc["n_hydro_iter"],
           "advance_s_per_interval": rows[:, 3].tolist(),
           "ms_per_step": rows[:, 4].tolist(),
           "steps_per_s": (1e3 / rows[:, 4]).tolist(),
           "command_wall_s": {"start_two": wall_a, "start_one": wall_b,
                              "restart_last": wall_r},
           "snapshot_write_s": write_s, "snapshot_bytes": nbytes,
           "restart_bitwise": True, "files_compared": len(files)}
    log(f"  command line {NR}x{NAZ} float32 (examples/adiabatic_disk.yml, "
        f"MonitorTimestep {CLI_SETUP['MonitorTimestep']}): "
        f"{misc['n_hydro_iter']} hydro steps in 2 intervals, advance "
        f"{', '.join(f'{x:.4f}' for x in res['advance_s_per_interval'])} s "
        f"a monitor interval, "
        f"{', '.join(f'{x:.1f}' for x in res['steps_per_s'])} steps/s; "
        f"whole commands: start (2 snapshots) {wall_a:.2f} s, start (1) "
        f"{wall_b:.2f} s, restart last {wall_r:.2f} s [{gpu}]")
    log(f"  one snapshot write: {write_s:.4f} s, {nbytes} bytes "
        f"({nbytes / write_s / 1e9:.3f} GB/s) [{gpu}]")
    log(f"  restart: run B (1 snapshot + restart last) against run A: "
        f"{len(files)} files, every one OK at rtol 0 (bit for bit)")
    log("  launches in run A: " + ", ".join(
        f"{k} {launches[k]}" for k in CLI_OPS))
    return res


# a few steps of setups/gamma_cephei_full.yml as it stands, at its own
# 1609x1160: snapshot 0 holds every writer of the setup
BINARY_CLI_STEPS = 5
BINARY_CLI_FILES = ("Sigma", "vrad", "vazi", "energy", "Viscosity",
                    "AspectRatio", "MassFlow", "Qplus", "Qminus")


def binary_command_line(work, gpu) -> dict:
    """``python -m fargocpt_torch start setups/gamma_cephei_full.yml
    --dtype float32 -N BINARY_CLI_STEPS`` in this process, the launch
    counters set to 0 just before and read just after (BINARY_OPS a step,
    no other kernel); snapshot 0's files, those of WriteViscosity,
    WriteAspectratio and WriteMassFlow among them, finite."""
    from fargocpt_torch.ops import kernels as K
    outdir = os.path.join(work, "gamma_cephei_full")
    telemetry.reset("launch.")
    wall = run_cli(["start", os.path.join(HERE, "setups",
                                          "gamma_cephei_full.yml"),
                    "--dtype", "float32", "-o", outdir,
                    "-N", str(BINARY_CLI_STEPS)])
    launches = telemetry.values("launch.", K.OPS)
    for name in K.OPS:
        if not launch_count_ok(name, launches[name],
                               BINARY_OPS.get(name, 0) * BINARY_CLI_STEPS):
            raise AssertionError(f"gamma_cephei_full.yml launched {name} "
                                 f"{launches[name]} times in "
                                 f"{BINARY_CLI_STEPS} steps")
    sdir = os.path.join(outdir, "snapshots", "0")
    sizes = {}
    for name in BINARY_CLI_FILES:
        arr = np.fromfile(os.path.join(sdir, f"{name}.dat"), np.float64)
        if arr.size < NR_BINARY * NAZ_BINARY or not np.isfinite(arr).all():
            raise AssertionError(f"gamma_cephei_full.yml snapshot 0: "
                                 f"{name} ({arr.size} values)")
        sizes[name] = int(arr.size)
    log(f"  setups/gamma_cephei_full.yml {NR_BINARY}x{NAZ_BINARY} float32: "
        f"start -N {BINARY_CLI_STEPS} in {wall:.2f} s (the initial "
        f"conditions and snapshot 0 included); snapshot 0 files "
        f"{', '.join(BINARY_CLI_FILES)} finite; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{gpu}]")
    return {"grid": f"{NR_BINARY}x{NAZ_BINARY}", "dtype": "float32",
            "steps": BINARY_CLI_STEPS, "command_wall_s": wall,
            "launches": launches, "snapshot_0_values": sizes}


# setups/CloseBinaries/OY_Car.yml at its own 200x200 in float64, the
# stream's ramp ending in the first step and monitor intervals of ~40
# steps (the setup's own 0.0628 would be ~2e5), two intervals a snapshot,
# Q+ / Q- in the snapshots (the CFL reads them)
OY_CAR_CLI = {"FirstDT": 1e-7, "ROFrampingtime": 1e-7,
              "MonitorTimestep": 1e-5, "Nmonitor": 2,
              "BitwiseExactRestarting": "yes"}


def oy_car_cli_setup(path, n_snapshots) -> str:
    return yaml_setup("setups/CloseBinaries/OY_Car.yml", path, **OY_CAR_CLI,
                      Nsnapshots=n_snapshots)


def oy_car_command_line(work, gpu) -> dict:
    """Run A: ``start --dtype float64`` of OY_Car through two snapshots
    (four monitor intervals), the launch counters set to 0 just before and
    read just after (OY_CAR_OPS a step and the fresh start's two cfl
    launches, no other kernel). Run B: one
    snapshot, then ``restart last`` to the second;
    tools/compare_output.py --rtol 0 holds every file of B against A,
    massflow_tracker.bin among them."""
    from fargocpt_torch import output as out
    from fargocpt_torch.ops import kernels as K
    two = oy_car_cli_setup(os.path.join(work, "oy_two.yml"), 2)
    one = oy_car_cli_setup(os.path.join(work, "oy_one.yml"), 1)
    dir_a, dir_b = os.path.join(work, "oy_a"), os.path.join(work, "oy_b")
    telemetry.reset("launch.")
    wall_a = run_cli(["start", two, "--dtype", "float64", "-o", dir_a])
    launches = telemetry.values("launch.", K.OPS)
    misc = out.load_misc(os.path.join(dir_a, "snapshots", "2"))
    n = misc["n_hydro_iter"]
    for name in K.OPS:
        # a fresh start takes two time steps before its loop
        # (Simulation.begin): two more cfl launches
        want = OY_CAR_OPS.get(name, 0) * n + (2 if name == "cfl" else 0)
        if not launch_count_ok(name, launches[name], want):
            raise AssertionError(f"OY_Car.yml launched {name} "
                                 f"{launches[name]} times in {n} steps")
    wall_b = run_cli(["start", one, "--dtype", "float64", "-o", dir_b])
    wall_r = run_cli(["restart", "last", two, "--dtype", "float64", "-o",
                      dir_b])
    files = compare_runs(dir_a, dir_b, must=("massflow_tracker.bin",))
    check_state_arrays(dir_a)
    tracker = np.fromfile(os.path.join(dir_a, "snapshots", "2",
                                       "massflow_tracker.bin"), np.float64)
    rows = np.atleast_2d(np.loadtxt(os.path.join(
        dir_a, "monitor", "timestepLogging.dat")))
    log(f"  setups/CloseBinaries/OY_Car.yml {NR_OY_CAR}x{NAZ_OY_CAR} "
        f"float64 (MonitorTimestep {OY_CAR_CLI['MonitorTimestep']}, the "
        f"stream's ramp 1e-7 orbits): {n} hydro steps in 4 intervals, "
        f"{', '.join(f'{1e3 / x:.1f}' for x in rows[:, 4])} steps/s; start "
        f"(2 snapshots) {wall_a:.2f} s, start (1) {wall_b:.2f} s, restart "
        f"last {wall_r:.2f} s; the tracker [0, {tracker[1]:.6e}, "
        f"{tracker[2]:.6e}]; restart: {len(files)} files of the last "
        f"snapshot bit for bit, massflow_tracker.bin among them; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{gpu}]")
    return {"grid": f"{NR_OY_CAR}x{NAZ_OY_CAR}", "dtype": "float64",
            "hydro_steps": n, "launches": launches,
            "steps_per_s": (1e3 / rows[:, 4]).tolist(),
            "command_wall_s": {"start_two": wall_a, "start_one": wall_b,
                               "restart_last": wall_r},
            "tracker": tracker.tolist(), "restart_bitwise": True,
            "files_compared": len(files)}


# setups/single_planet_no_disk.yml (Disk: no) with monitor intervals of 10
# steps of its first dt, two intervals a snapshot
NO_DISK_CLI = {"MonitorTimestep": 0.01, "Nmonitor": 2}
NO_DISK_OPS = {"ias15": 2, "bodies_on_grid": 1}


def no_disk_command_line(work, gpu) -> dict:
    """Run A: ``start --dtype float64`` of setups/single_planet_no_disk.yml
    through two snapshots (four monitor intervals of 10 steps), the launch
    counters set to 0 just before and read just after (ias15 twice a step,
    no other kernel: no CFL, no gas step). Run B: one snapshot, then
    ``restart last`` to the second; every file of B's last snapshot bit
    for bit A's. The bodies moved and the gas did not."""
    from fargocpt_torch import output as out
    from fargocpt_torch.ops import kernels as K
    src = "setups/single_planet_no_disk.yml"
    two = yaml_setup(src, os.path.join(work, "nd_two.yml"), Nsnapshots=2,
                     **NO_DISK_CLI)
    one = yaml_setup(src, os.path.join(work, "nd_one.yml"), Nsnapshots=1,
                     **NO_DISK_CLI)
    dir_a, dir_b = os.path.join(work, "nd_a"), os.path.join(work, "nd_b")
    telemetry.reset("launch.")
    wall_a = run_cli(["start", two, "--dtype", "float64", "-o", dir_a])
    launches = telemetry.values("launch.", K.OPS)
    n = out.load_misc(os.path.join(dir_a, "snapshots", "2"))["n_hydro_iter"]
    for name in K.OPS:
        if not launch_count_ok(name, launches[name],
                               NO_DISK_OPS.get(name, 0) * n):
            raise AssertionError(f"single_planet_no_disk.yml launched {name} "
                                 f"{launches[name]} times in {n} steps")
    wall_b = run_cli(["start", one, "--dtype", "float64", "-o", dir_b])
    wall_r = run_cli(["restart", "last", two, "--dtype", "float64", "-o",
                      dir_b])
    files = compare_runs(dir_a, dir_b)
    rows = {k: np.atleast_2d(np.loadtxt(os.path.join(
        dir_a, "monitor", f"nbody{k}.dat"))) for k in (0, 1)}
    sig = [np.fromfile(os.path.join(dir_a, "snapshots", s, "Sigma.dat"))
           for s in ("0", "2")]
    if not np.array_equal(sig[0], sig[1]):
        raise AssertionError("Disk: no moved the gas")
    planet = rows[1][:, 2:4]
    moved = float(np.hypot(*(planet[-1] - planet[0])))
    if not (moved > 1e-2 and np.isfinite(planet).all()):
        raise AssertionError(f"Disk: no: the planet moved by {moved}")
    log(f"  setups/single_planet_no_disk.yml float64 (Disk: no, "
        f"MonitorTimestep {NO_DISK_CLI['MonitorTimestep']}): {n} hydro "
        f"steps in 4 intervals; start (2 snapshots) {wall_a:.2f} s, start "
        f"(1) {wall_b:.2f} s, restart last {wall_r:.2f} s; the planet moved "
        f"{moved:.4f}, the gas not at all; restart: {len(files)} files "
        f"bit for bit; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{gpu}]")
    return {"hydro_steps": n, "launches": launches,
            "command_wall_s": {"start_two": wall_a, "start_one": wall_b,
                               "restart_last": wall_r},
            "planet_moved": moved, "restart_bitwise": True,
            "files_compared": len(files)}


FULL_PHYSICS_CLI_STEPS = 20


def full_physics_command_line(work, gpu) -> dict:
    """``start examples/full_physics.yml --dtype float64 -N 20`` in this
    process (float64: the swarm dies on its first float32 step in both
    packages), the launch counters set to 0 just before and read just
    after (FULL_PHYSICS_OPS a step and the fresh start's two cfl launches,
    no other kernel); snapshot 0's fields and particles.bin finite, and
    the swarm alive at the end."""
    from fargocpt_torch.ops import kernels as K
    setup = yaml_setup("examples/full_physics.yml",
                       os.path.join(work, "full_physics.yml"),
                       FirstDT=1e-3)
    outdir = os.path.join(work, "full_physics")
    telemetry.reset("launch.")
    wall = run_cli(["start", setup, "--dtype", "float64", "-o", outdir,
                    "-N", str(FULL_PHYSICS_CLI_STEPS)])
    launches = telemetry.values("launch.", K.OPS)
    n = FULL_PHYSICS_CLI_STEPS
    for name in K.OPS:
        want = FULL_PHYSICS_OPS.get(name, 0) * n + (2 if name == "cfl"
                                                    else 0)
        if launches[name] != want:
            raise AssertionError(f"full_physics.yml launched {name} "
                                 f"{launches[name]} times in {n} steps")
    sdir = os.path.join(outdir, "snapshots", "0")
    for name in ("Sigma", "vrad", "vazi", "energy", "particles"):
        arr = np.fromfile(os.path.join(
            sdir, f"{name}.{'bin' if name == 'particles' else 'dat'}"))
        if not (arr.size and np.isfinite(arr).all()):
            raise AssertionError(f"full_physics.yml snapshot 0: {name}")
    log(f"  examples/full_physics.yml {NR_FULL}x{NAZ_FULL} float64: start "
        f"-N {n} in {wall:.2f} s (the initial conditions and snapshot 0 "
        f"included); snapshot 0 finite, particles.bin among it; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{gpu}]")
    return {"grid": f"{NR_FULL}x{NAZ_FULL}", "dtype": "float64",
            "steps": n, "command_wall_s": wall, "launches": launches}


def check_state_arrays(outdir) -> None:
    """The last snapshot's fields are finite, sigma positive."""
    sdir = os.path.join(outdir, "snapshots", "2")
    for name in ("Sigma", "vrad", "vazi", "energy"):
        arr = np.fromfile(os.path.join(sdir, f"{name}.dat"), np.float64)
        if not np.isfinite(arr).all():
            raise AssertionError(f"snapshot 2: {name} is not finite")
    if not (np.fromfile(os.path.join(sdir, "Sigma.dat")) > 0).all():
        raise AssertionError("snapshot 2: sigma <= 0 somewhere")


# --- phase 6 -----------------------------------------------------------------

# the reference-binary goldens this port reproduces, and their gates
# (tests/test_reference_golden.py)
GOLDENS = (("cold_disk_planet", 1e-6), ("spreading_ring", 1e-9),
           ("shocktube_sn", 1e-6), ("longrun_planet", 1e-5),
           ("planet_torque", 1e-6), ("binary_gceph", 1e-5),
           ("temperature_test", 1e-6), ("temperature_fld", 1e-6),
           ("planet_accretion", 1e-6), ("binary_gcfull", 1e-5))
# the goldens' MassFlow.dat and its gate: the deviation the JAX package's
# own CPU run leaves on it, rounded up
# (tests/test_torch_goldens_leapfrog.py)
MASSFLOW_GATES = {"temperature_test": 1e-10, "temperature_fld": 3e-8}


def golden_on_card(name, tol, work, gpu, cfg=None, label=None) -> dict:
    """One golden's setup (or ``cfg``, a variant of it named ``label``) in
    float64 on the card through the kernels and fargocpt_torch.output, its
    launch counters set to 0 just before and read just after; its
    snapshots against tests/goldens/<name>/ as
    tests/test_reference_golden.py holds them: every field's largest
    deviation over its largest value under ``tol``, the same hydro step
    count and last dt in misc.bin."""
    from fargocpt_torch import output as out
    from fargocpt_torch.config import Config
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.sim import Simulation
    golden = os.path.join(HERE, "tests", "goldens", name)
    label = label or name
    outdir = os.path.join(work, label.replace("@", "_"))
    if cfg is None:
        cfg = Config.from_file(os.path.join(golden, "setup.yml"))
    telemetry.reset("launch.")
    t0 = time.perf_counter()
    sim = Simulation(cfg, outdir=outdir, dtype="float64")
    writer = out.OutputWriter(sim)
    sim.run()
    writer.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in telemetry.values("launch.", K.OPS).items()
                if v}
    nr, na = sim.geometry.nrad, sim.geometry.naz
    ref_rad = np.loadtxt(os.path.join(golden, "used_rad.dat"))
    if not np.allclose(sim.geometry.radii[:nr + 1], ref_rad, rtol=1e-12,
                       atol=0.0):
        raise AssertionError(f"{name}: the grid differs")
    fields = [("Sigma", nr), ("vrad", nr + 1), ("vazi", nr)]
    if os.path.exists(os.path.join(golden, "snapshots", "1", "energy.dat")):
        fields.append(("energy", nr))
    devs, steps = {}, {}
    for snap in ("1", "2"):
        for field, rows in fields:
            g = np.fromfile(os.path.join(golden, "snapshots", snap,
                                         f"{field}.dat"))
            m = np.fromfile(os.path.join(outdir, "snapshots", snap,
                                         f"{field}.dat"))
            if not g.shape == m.shape == (rows * na,):
                raise AssertionError(f"{name} {snap} {field}: shape")
            devs[f"{snap}/{field}"] = float(np.max(np.abs(g - m))
                                            / np.max(np.abs(g)))
        misc = {}
        for who, d in (("ref", golden), ("port", outdir)):
            raw = open(os.path.join(d, "snapshots", snap, "misc.bin"),
                       "rb").read()
            misc[who] = (int(np.frombuffer(raw[40:44], np.uint32)[0]),
                         float(np.frombuffer(raw[32:40], np.float64)[0]))
        steps[snap] = misc
        if name in MASSFLOW_GATES:
            # the reference's file holds NR + 1 rows, one a face, the
            # port's NR; the reflecting outer face carries no mass
            g = np.fromfile(os.path.join(golden, "snapshots", snap,
                                         "MassFlow.dat")).reshape(nr + 1, na)
            m = np.fromfile(os.path.join(outdir, "snapshots", snap,
                                         "MassFlow.dat")).reshape(nr, na)
            if g[nr].any():
                raise AssertionError(f"{name} {snap}: MassFlow's outer row")
            devs[f"{snap}/MassFlow"] = float(np.max(np.abs(g[:nr] - m))
                                             / np.max(np.abs(g)))
    log(f"  {label} {nr}x{na} float64: "
        f"{wall:.2f} s, {sim.n_hydro_iter} "
        f"hydro steps; max rel dev "
        + ", ".join(f"{k} {v:.3e}" for k, v in devs.items())
        + f" (gate {tol:.0e}); steps and last dt (ref, port): "
        + "; ".join(f"{s} {v['ref']} {v['port']}" for s, v in steps.items())
        + f"; launches {launches} [{gpu}]")
    for key, dev in devs.items():
        gate = MASSFLOW_GATES[name] if key.endswith("MassFlow") else tol
        if not dev < gate:
            raise AssertionError(f"{name} {key}: max rel dev {dev:.3e} >= "
                                 f"{gate}")
    for snap, v in steps.items():
        if v["ref"][0] != v["port"][0]:
            raise AssertionError(f"{name} snapshot {snap}: {v['port'][0]} "
                                 f"hydro steps, the reference {v['ref'][0]}")
        if not abs(v["ref"][1] - v["port"][1]) / v["ref"][1] \
                < max(1e-6, tol):
            raise AssertionError(f"{name} snapshot {snap}: last dt "
                                 f"{v['port'][1]} against {v['ref'][1]}")
    if sim.stepper.n_bodies > 1 and not launches.get("ias15"):
        raise AssertionError(f"{name}: ias15 was not launched")
    return {"seconds": wall, "hydro_steps": sim.n_hydro_iter,
            "max_rel_dev": devs, "launches": launches}


def pvte_bisection_ms(gpu, steps=20) -> dict:
    """The shocktube_pvte golden's setup with the float64 bisection solve
    (no lookup table) on the card: ms a step (calculate_time_step +
    step_once, after 5 warm-up steps) and the run's 3283 steps at that
    rate."""
    from fargocpt_torch.flagship import shocktube_pvte
    from fargocpt_torch.sim import Simulation
    sim = Simulation(shocktube_pvte(lookup=False), dtype="float64")
    for _ in range(5):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    check_state(sim)
    log(f"  shocktube_pvte (the float64 bisection) 1000x2: {ms:.4f} ms a "
        f"step on the card, so its 3283 steps would take "
        f"{ms * 3283 / 1e3:.1f} s: left to the CPU tests' slow tier [{gpu}]")
    return {"ms_per_step": ms, "estimated_golden_s": ms * 3283 / 1e3}


# --- 7. the radial decomposition on ranks sharing the card -------------
SHARD_SMALL = (192, 64)       # tests/test_shard_map.py's flagship grid
SHARD_STEPS = 5               # float32 steps at full width
SHARD_TIMED = 10              # timed steps of each run
SHARD_OPS = ("cfl", "sources", "viscous_kick", "transport")
# the cases of tests/shard_ranks.py the 4-rank world runs on the card, each
# three steps of 1e-4 sharded against one process, with the CPU tests'
# gates (tests/test_torch_shard.py): (name, dtype, the grids' gate, the
# case's own values, their gate), each a largest difference over its scale
SHARD_CASES = (
    ("fld", "float64", 5e-12, ("fld_sor",), 1e-12),
    ("selfgravity", "float64", 5e-12,
     ("sg_kernel.0", "sg_kernel.1", "sg_kernel.2"), 1e-12),
    ("buckets", "float64", 1e-13,
     tuple(f"particles.{f}" for f in ("r", "phi", "r_dot", "phi_dot",
                                      "stokes", "timestep")), 1e-12),
    ("pvte", "float32", 5e-6, ("pvte_guess.0", "pvte_guess.1"), 5e-6))
# parallel.run on 4 ranks with DistributedOutput: two snapshots
SHARD_RUN = {"DistributedOutput": "yes", "Nsnapshots": 2,
             "MonitorTimestep": 0.01}
GRIDS = ("fields.sigma", "fields.vrad", "fields.vaz", "fields.energy",
         "qplus", "qminus")


def _shard_ranks():
    """tests/shard_ranks.py: the sharded cases and rank functions of the
    CPU tests (it imports no JAX)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import shard_ranks
    return shard_ranks


def rank_shard_cases(comm, outdir) -> dict:
    """One rank of phase 7's 4-rank world beyond the flagship: each case
    of SHARD_CASES (FLD's per-sweep halo refresh, self-gravity's
    all_gather, the buckets' migration, artvisc_sn and the PVTE pair in a
    window) sharded against one process on the card, reduced here to each
    value's largest difference over its scale; then ``parallel.run`` of
    the flagship with SHARD_RUN into ``outdir`` and its last snapshot's
    row files restored onto the ranks."""
    from fargocpt_torch.ops import kernels as K
    sr = _shard_ranks()
    out = {}
    for name, dtype, _, extras, _ in SHARD_CASES:
        t0 = time.perf_counter()
        telemetry.reset("launch.")
        r = sr.rank_case(comm, name, dtype=dtype)
        torch.cuda.synchronize()
        s1, s2 = r.pop("states")
        r.update(diffs={k: sr.rel(s1[k], s2[k]) for k in GRIDS + extras},
                 launches=telemetry.values("launch.", K.OPS),
                 s=time.perf_counter() - t0)
        if name == "buckets":
            r["alive_equal"] = bool(np.array_equal(s1["particles.alive"],
                                                   s2["particles.alive"]))
        if name == "selfgravity":
            r["alpha_grav_mean"] = sr.rel(s1["monitor_acc.alpha_grav_mean"],
                                          s2["monitor_acc.alpha_grav_mean"])
        out[name] = r
    t0 = time.perf_counter()
    cfg = sr.config(None, **SHARD_RUN)
    final, n_steps = sr.rank_run(comm, cfg, outdir)
    back, t_back, _ = sr.rank_restore(comm, cfg, outdir,
                                      SHARD_RUN["Nsnapshots"])
    out["run"] = {"n_steps": n_steps, "time": t_back,
                  "restored_equal": all(np.array_equal(final[k], back[k])
                                        for k in GRIDS[:4]),
                  "s": time.perf_counter() - t0}
    return out


def check_shard_cases(ranks, outdir, gpu) -> dict:
    """The 4-rank cases against the CPU tests' gates, and the sharded
    run's files against one process's run of the same setup on the card:
    the row files reassembled, the 1-D files, misc.bin, nbody.bin and
    the monitor files byte for byte."""
    from pathlib import Path
    from fargocpt_torch import output as tout
    from fargocpt_torch.config import Config
    from fargocpt_torch.sim import Simulation
    sr = _shard_ranks()
    res = {}
    for name, _, gate, extras, extras_gate in SHARD_CASES:
        cases = [r["cases"][name] for r in ranks]
        for k, c in enumerate(cases):
            bad = {key: v for key, v in c["diffs"].items()
                   if not v < (extras_gate if key in extras else gate)}
            if bad or not c.get("alive_equal", True):
                raise AssertionError(f"4 ranks: rank {k} {name} "
                                     f"{bad or 'particles.alive differ'}")
        c0 = cases[0]
        fails = {
            "fld": lambda: c0["fld_iterations"][0] != c0["fld_iterations"][1],
            "selfgravity": lambda: not c0["alpha_grav_mean"] < 1e-3 or any(
                c["bytes"]["all_gather"]
                != 3 * c["model"]["selfgravity_allgather"] for c in cases),
            "buckets": lambda: sum(c["overflow"] for c in cases) != 0
            or not np.array_equal(np.sort(np.concatenate(
                [c["pids"] for c in cases])), np.arange(64)),
            "pvte": lambda: not c0["launches"].get("artvisc_sn", 0) > 0,
        }
        if fails[name]():
            raise AssertionError(f"4 ranks: {name} {c0}")
        worst = max(max(c["diffs"].values()) for c in cases)
        res[name] = {"max_rel": worst, "s": c0["s"],
                     "launches": c0["launches"]}
        log(f"  4 ranks {name} ({c0['s']:.1f} s): largest difference "
            f"{worst:.3e} of scale against one process (gates {gate:g}, "
            f"{extras_gate:g}); kernels of both runs {c0['launches']}")
    run = ranks[0]["cases"]["run"]
    if not all(r["cases"]["run"]["restored_equal"] for r in ranks):
        raise AssertionError("the row files did not restore bit for bit")
    serial = Path(outdir).parent / "serial"
    sim = Simulation(Config.from_dict(sr.config(None, **SHARD_RUN)),
                     device="cuda")
    writer = tout.OutputWriter(sim, serial)
    sim.run()
    writer.close()
    if sim.n_hydro_iter != run["n_steps"]:
        raise AssertionError(f"run: {run['n_steps']} sharded steps, "
                             f"{sim.n_hydro_iter} on one process")
    n_files = 0
    for sid in map(str, range(SHARD_RUN["Nsnapshots"] + 1)):
        a, b = serial / "snapshots" / sid, Path(outdir) / "snapshots" / sid
        for f in sorted(a.iterdir()):
            if f.name == "config.yml":
                continue              # the directories differ in it
            rows = tout.row_files(b, f.name[:-4])
            if rows:
                got = b"".join(p.read_bytes() for _, _, p in rows)
            else:
                got = (b / f.name).read_bytes()
            if got != f.read_bytes():
                raise AssertionError(f"run: snapshot {sid} {f.name} differs "
                                     "from one process's")
            n_files += 1
    for name in ("Quantities.dat", "nbody0.dat"):
        if (serial / "monitor" / name).read_bytes() \
                != (Path(outdir) / "monitor" / name).read_bytes():
            raise AssertionError(f"run: monitor/{name} differs")
    log(f"  4 ranks parallel.run with DistributedOutput ({run['s']:.1f} s, "
        f"{run['n_steps']} steps): {n_files} snapshot files and the monitor "
        f"files equal one process's byte for byte; the last snapshot's row "
        f"files restore onto the ranks bit for bit [{gpu}]")
    res["run"] = {**run, "files_equal": n_files}
    return res


def _field_diffs(a, b, names=("sigma", "vrad", "vaz", "energy"),
                 scale=False) -> dict:
    """Each field's largest difference, over its largest magnitude where
    ``scale``."""
    out = {}
    for name in names:
        x, y = getattr(a.fields, name), getattr(b.fields, name)
        d = float((x - y).abs().max())
        out[name] = d / max(float(x.abs().max()), 1e-300) if scale else d
    for name in ("qplus", "qminus"):
        x, y = getattr(a, name), getattr(b, name)
        d = float((x - y).abs().max())
        out[name] = d / max(float(x.abs().max()), 1e-300) if scale else d
    return out


def rank_sharded(comm, full: bool, outdir=None) -> dict:
    """One rank of phase 7: the flagship at 192x64 float64 (one step of
    2e-4 and an interval to t = 0.05, sharded against the single-process
    run on the card, both through the kernels, the kernels counted around
    the sharded calls only); with ``full`` the flagship at 1024x3072
    float32 (SHARD_STEPS steps on the single-process run's CFL dt, each
    field within F32_TOL of its scale), then SHARD_TIMED steps of CFL +
    step of each run timed (the single-process one on rank 0 alone, the
    others waiting) and the bytes the communicator sent a step."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.parallel.shard_step import ShardedHydroStep
    out = {"rank": comm.rank}
    sim = flagship(*SHARD_SMALL, "float64", comm.device)
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    telemetry.reset("launch.")
    loc = ss.step(local, 0.0, 2e-4)
    torch.cuda.synchronize()
    out["launches_step"] = telemetry.values("launch.", K.OPS)
    one = sim.stepper.step(sim.state, 0.0, 2e-4)
    out["f64_step"] = _field_diffs(one, ss.gather(loc), scale=True)
    o1 = sim.stepper.advance_to(sim.state, 0.0, 1e-4, 0.05)
    telemetry.reset("launch.")
    o2 = ss.advance_to(local, 0.0, 1e-4, 0.05)
    torch.cuda.synchronize()
    out["launches_interval"] = telemetry.values("launch.", K.OPS)
    out["f64_interval"] = _field_diffs(o1[0], ss.gather(o2[0]), scale=True)
    out["interval"] = ((o1[3], float(o1[1]), float(o1[2])),
                       (o2[3], float(o2[1]), float(o2[2])))
    if not full:
        out["cases"] = rank_shard_cases(comm, outdir)
        return out
    del sim, ss, local, loc, one, o1, o2
    sim = flagship(NR, NAZ, "float32", comm.device)
    ss = ShardedHydroStep(sim.stepper, comm)
    local = ss.shard_state(sim.state)
    state, t, dts = sim.state, 0.0, []
    for _ in range(SHARD_STEPS):
        dt = float(sim.stepper.cfl_dt(state))
        state = sim.stepper.step(state, t, dt)
        dts.append((t, dt))
        t += dt
    telemetry.reset("launch.")
    cfl_rel = 0.0
    for t, dt in dts:
        dt_s = float(ss.cfl_dt(local))
        cfl_rel = max(cfl_rel, abs(dt_s - dt) / dt)
        local = ss.step(local, t, dt)
    torch.cuda.synchronize()
    out["launches_f32"] = telemetry.values("launch.", K.OPS)
    out["f32_cfl_rel"] = cfl_rel
    out["f32_steps"] = _field_diffs(state, ss.gather(local), scale=True)
    out["comm_model"] = ss.comm_model()

    def timed(run):
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SHARD_TIMED * 1e3

    def single():
        sim.stepper.advance_to(sim.state, 0.0, 1e-4, 1.0,
                               max_steps=SHARD_TIMED)
    if comm.rank == 0:
        single()                                   # warm
        out["single_ms"] = timed(single)
    else:
        out["single_ms"] = timed(lambda: None)
    ss.advance_to(local, 0.0, 1e-4, 1.0, max_steps=2)     # warm
    telemetry.reset("comm.bytes.")
    out["sharded_ms"] = timed(lambda: ss.advance_to(
        local, 0.0, 1e-4, 1.0, max_steps=SHARD_TIMED))
    out["bytes_per_step"] = {
        k: v // SHARD_TIMED
        for k, v in telemetry.values("comm.bytes.", KINDS).items()}
    return out


def sharded_phase(gpu) -> dict:
    """Phase 7: ``fargocpt_torch.parallel`` on ranks that share the one
    card over gloo (each collective staged through the host): 2 ranks with
    the full checks of ``rank_sharded``, then 4 at 192x64 float64. The
    float64 gates are the JAX package's (tests/test_shard_map.py): 1e-13
    of each field's scale for a step, 1e-11 for an interval, the same step
    count and landing time. NCCL, which needs a card a rank, is refused by
    name on this one-card host."""
    from fargocpt_torch.parallel import launch as plaunch
    try:
        plaunch.check_pair("nccl", "cuda", 2)
    except ValueError as e:
        log(f"  nccl with 2 ranks refused: {e}")
    else:
        if torch.cuda.device_count() < 2:
            raise AssertionError("nccl was not refused on one card")
    res = {}
    # the ranks meet at a file of their own, not at a port that another
    # process could take first
    work = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    for n, full in ((2, True), (4, False)):
        t0 = time.perf_counter()
        outdir = os.path.join(work, f"rows_{n}")
        ranks = plaunch.launch(
            rank_sharded, n, backend="gloo", device="cuda",
            args=(full, outdir),
            init_method=f"file://{os.path.join(work, f'store_{n}')}")
        wall = time.perf_counter() - t0
        for r in ranks:
            for label in ("launches_step", "launches_interval") + (
                    ("launches_f32",) if full else ()):
                # a lone step takes no CFL
                for op in SHARD_OPS[label == "launches_step":]:
                    if not r[label][op] > 0:
                        raise AssertionError(
                            f"{n} ranks: rank {r['rank']} launched no {op} "
                            f"in its {label[9:]}")
            for label, gate in (("f64_step", 1e-13), ("f64_interval", 1e-11)):
                worst = max(r[label].values())
                if not worst < gate:
                    raise AssertionError(f"{n} ranks: rank {r['rank']} "
                                         f"{label} {r[label]}")
            (n1, t1, _), (n2, t2, _) = r["interval"]
            if (n1, t1) != (n2, t2) or r["interval"] != ranks[0]["interval"]:
                raise AssertionError(f"{n} ranks: interval {r['interval']}")
            if full and not max(r["f32_steps"].values()) < F32_TOL:
                raise AssertionError(f"{n} ranks: rank {r['rank']} float32 "
                                     f"{r['f32_steps']}")
        r0 = ranks[0]
        log(f"  {n} ranks sharing the card (gloo, host-staged), "
            f"{SHARD_SMALL[0]}x{SHARD_SMALL[1]} float64 against one "
            f"process: step {max(r0['f64_step'].values()):.3e}, interval "
            f"to 0.05 ({r0['interval'][1][0]} steps) "
            f"{max(max(r['f64_interval'].values()) for r in ranks):.3e} of "
            f"scale; kernels of a sharded step {r0['launches_step']}; "
            f"world {wall:.1f} s")
        entry = {"wall_s": wall, "ranks": ranks}
        if full:
            worst = max(max(r["f32_steps"].values()) for r in ranks)
            model = r0["comm_model"]
            log(f"  {n} ranks {NR}x{NAZ} float32, {SHARD_STEPS} steps: "
                f"largest field difference {worst:.3e} of scale, the "
                f"sharded CFL dt within "
                f"{max(r['f32_cfl_rel'] for r in ranks):.3e} of the one "
                f"process's; kernels {r0['launches_f32']}")
            log(f"  {n} ranks sharing one card, not a scaling figure: "
                f"sharded {max(r['sharded_ms'] for r in ranks):.4f} ms/step "
                f"(CFL + step), one process {r0['single_ms']:.4f} ms/step "
                f"[{gpu}]")
            log(f"  bytes a step by kind, each rank: "
                + "; ".join(f"rank {r['rank']} {r['bytes_per_step']}"
                            for r in ranks)
                + f"; comm_model (an interior rank) {model}")
            entry["f32_max_rel"] = worst
        else:
            entry["cases"] = check_shard_cases(ranks, outdir, gpu)
            for r in ranks:
                del r["cases"]
        res[f"ranks_{n}"] = entry
    shutil.rmtree(work, ignore_errors=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "device", file=sys.stderr)
        return 2
    from fargocpt_torch.ops import kernels as K

    t_main = time.perf_counter()
    log("== 1. environment")
    gpu = gpu_line()
    log(gpu)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    info = K.build()
    log(f"nvcc {info.nvcc}; library {os.path.relpath(info.library, HERE)}; "
        f"compile + link {info.seconds:.2f} s (one nvcc per source, "
        f"concurrent); build+load "
        f"{time.perf_counter() - t0:.2f} s")

    if set(KERNELS) != set(K.OPS):
        raise AssertionError(f"KERNELS {sorted(KERNELS)} and kernels.OPS "
                             f"{sorted(K.OPS)} differ")
    log("== 2. per-kernel parity (kernel vs plain on the GPU)")
    t0 = time.perf_counter()
    sim = flagship(NR, NAZ, "float32", "cuda")
    sim_split = flagship_split(NR_SPLIT, NAZ, "float32", "cuda")
    log(f"  flagship {NR}x{NAZ} and {NR_SPLIT}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured = parity_f32_flagship(sim, gpu)
    split_measured, route_ms = parity_f32_split(sim_split, gpu)
    measured.update(split_measured)
    staged_measured, route3_ms = parity_f32_staged(sim, gpu)
    measured.update(staged_measured)
    t0 = time.perf_counter()
    sim_gas = pds70_gas(NR, NAZ, "float32", "cuda")
    log(f"  PDS70 gas {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured.update(parity_f32_pds70(sim_gas))
    t0 = time.perf_counter()
    sim_planet = planet_disk(NR, NAZ, "float32", "cuda")
    log(f"  planet_disk {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured_planet = parity_f32_planet(sim_planet, gpu)
    ias15_res = ias15_parity(sim_planet, gpu)
    measured["ias15"] = {k: v for k, v in ias15_res["planet_disk"].items()
                         if k not in ("plain_launches", "steps")}
    measured_leapfrog = parity_leapfrog(sim, gpu)
    measured["pvte_refresh"] = pvte_refresh_parity(gpu)
    measured["bodies_on_grid"] = bodies_on_grid_parity(gpu)
    parity_f64_ragged(torch.device("cuda"))
    parity_tile_edges(torch.device("cuda"))
    golden_grid_edges(torch.device("cuda"))
    log(f"  phase 2 done at {time.perf_counter() - t_main:.1f} s")

    log("== 3. the slices: flagship Simulation on the GPU, three routes "
        "and 1000 rings on the default route; a planet in the disk; the "
        "circumbinary disk; PDS70 gas; PDS70 with its dust")
    sim_staged = flagship_staged(NR, NAZ, "float32", "cuda")
    res = {"whole": run_slice(sim), "split": run_slice(sim_split),
           "staged": run_slice(sim_staged)}
    log_slice(res["whole"], NR, gpu)
    log_slice(res["split"], NR_SPLIT, gpu)
    log_slice(res["staged"], NR, gpu)
    del sim_staged
    # the route a grid with NR off a multiple of 16 takes by itself
    sim_1000 = flagship(NR_SPLIT, NAZ, "float32", "cuda")
    if sim_1000.stepper.ops.route != "whole":
        raise AssertionError(f"{NR_SPLIT} rings took the "
                             f"{sim_1000.stepper.ops.route} route")
    res["whole_1000"] = run_slice(sim_1000, steps=30)
    log_slice(res["whole_1000"], NR_SPLIT, gpu)
    del sim_1000
    turns = route_turns(sim_split)
    log(f"  {NR_SPLIT}x{NAZ} float32 in turns (split, whole, whole, split): "
        f"split route {turns['split']} ms/step, whole-transport kernel "
        f"{turns['whole']} ms/step [{gpu}]")
    order3 = ("staged", "split", "whole", "whole", "split", "staged")
    turns3 = route_turns(sim, order3)
    log(f"  {NR}x{NAZ} float32 in turns {order3}: "
        + ", ".join(f"{r} route {turns3[r]} ms/step" for r in K.ROUTES)
        + f" [{gpu}]")
    sync = host_sync_cost(sim)
    log(f"  host sync of one device scalar per step: {sync * 1e3:.4f} ms "
        f"[{gpu}]")
    del sim_split, sim
    res["planet_disk"] = run_planet(sim_planet)
    log_planet(res["planet_disk"], gpu)
    del sim_planet
    t0 = time.perf_counter()
    sim_torque = planet_torque(NR, NAZ, "float32", "cuda")
    log(f"  planet_torque {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["planet_torque"] = run_planet(sim_torque, ops=PLANET_TORQUE_OPS,
                                      label="planet_torque")
    log_planet(res["planet_torque"], gpu)
    del sim_torque
    t0 = time.perf_counter()
    sim_accretion = planet_accretion(NR, NAZ, "float32", "cuda")
    log(f"  planet_accretion {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["planet_accretion"] = run_planet(
        sim_accretion, ops=PLANET_ACCRETION_OPS, label="planet_accretion")
    log_planet(res["planet_accretion"], gpu)
    res["planet_accretion"]["sources_substep"] = unfused_sources(
        sim_accretion, gpu)
    acc = sim_accretion.state
    log(f"  planet_accretion after {sim_accretion.n_hydro_iter} steps: "
        f"planet mass {float(acc.nbody.mass[1]):.9e}, frame rate "
        f"{float(acc.omega_frame):.9f}, MassFlow grid sum "
        f"{float(acc.monitor_acc.massflow.sum()):.4e}")
    del sim_accretion
    t0 = time.perf_counter()
    sim_binary = binary_gcfull(NR_BINARY, NAZ_BINARY, "float32", "cuda")
    log(f"  binary_gcfull {NR_BINARY}x{NAZ_BINARY} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["binary_gcfull"] = run_planet(sim_binary, warmup=10, steps=30,
                                      ops=BINARY_OPS, label="binary_gcfull")
    log_planet(res["binary_gcfull"], gpu)
    if res["binary_gcfull"]["host_reads_per_step"] != 0:
        raise AssertionError("binary_gcfull reads the device from the host "
                             f"{res['binary_gcfull']['host_reads_per_step']}"
                             " times a step")
    res["binary_gcfull"]["transport_max_abs_err"] = \
        transport_parity(sim_binary)
    del sim_binary
    # the cataclysmic variables at their own grids, float64
    t0 = time.perf_counter()
    sim_oy = oy_car(NR_OY_CAR, NAZ_OY_CAR, "float64", "cuda")
    log(f"  oy_car {NR_OY_CAR}x{NAZ_OY_CAR} float64 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["oy_car"] = run_planet(sim_oy, ops=OY_CAR_OPS, label="oy_car")
    log_planet(res["oy_car"], gpu)
    res["oy_car"]["kernels"] = cv_kernel_parity(
        sim_oy, ("cfl", "sources", "artvisc_sn", "transport"))
    log(f"  oy_car after {sim_oy.n_hydro_iter} steps (t = "
        f"{float(sim_oy.time):.4e}): the tracker's rate "
        f"{float(sim_oy.state.monitor_acc.rof_mdot):.6e}")
    del sim_oy
    t0 = time.perf_counter()
    sim_v = v1504cyg(NR_V1504, NAZ_V1504, "float64", "cuda")
    log(f"  v1504cyg {NR_V1504}x{NAZ_V1504} float64 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["v1504cyg"] = run_planet(sim_v, warmup=5, steps=20,
                                 ops=V1504CYG_OPS, label="v1504cyg")
    log_planet(res["v1504cyg"], gpu)
    res["v1504cyg"]["transport_max_abs_err"] = transport_parity(
        sim_v, check_f64, dt=hydro_dt(sim_v))
    del sim_v
    for label in ("oy_car", "v1504cyg"):
        if res[label]["host_reads_per_step"] != 0:
            raise AssertionError(f"{label} reads the device from the host "
                                 f"{res[label]['host_reads_per_step']} "
                                 "times a step")
    # the long tail: a planet in a self-gravitating disk (Bessel kernel)
    # at full width, float32; examples/full_physics.yml at its own grid
    t0 = time.perf_counter()
    sim_sg = planet_disk_sg(NR, NAZ, "float32", "cuda")
    log(f"  planet_disk_sg {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["planet_disk_sg"] = run_planet(sim_sg, ops=PLANET_SG_OPS,
                                       label="planet_disk_sg")
    log_planet(res["planet_disk_sg"], gpu)
    if res["planet_disk_sg"]["host_reads_per_step"] != 0:
        raise AssertionError("planet_disk_sg reads the device from the host "
                             f"{res['planet_disk_sg']['host_reads_per_step']}"
                             " times a step")
    res["planet_disk_sg"]["transport_max_abs_err"] = transport_parity(sim_sg)
    del sim_sg
    t0 = time.perf_counter()
    sim_fp = full_physics(NR_FULL, NAZ_FULL, "float64", "cuda")
    log(f"  full_physics {NR_FULL}x{NAZ_FULL} float64 with "
        f"{sim_fp.state.particles.n} particles built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["full_physics"] = run_planet(sim_fp, ops=FULL_PHYSICS_OPS,
                                     label="full_physics")
    log_planet(res["full_physics"], gpu)
    res["full_physics"]["kernels"] = cv_kernel_parity(
        sim_fp, ("cfl", "sources", "artvisc_sn", "transport"), floors=True)
    # the smooth disk compresses too little for artvisc_sn to move its
    # outputs by more than their atol: held once more on the state with
    # seeded noise, where it does
    res["full_physics"]["artvisc_sn_perturbed"] = cv_kernel_parity(
        sim_fp, ("artvisc_sn",), f=perturbed(sim_fp))["artvisc_sn"]
    swarm = swarm_summary(sim_fp)
    res["full_physics"]["swarm"] = swarm
    log(f"  full_physics after {sim_fp.n_hydro_iter} steps (t = "
        f"{float(sim_fp.time):.4e}): {swarm['alive']} of {swarm['n']} "
        f"particles alive, their radii {swarm['r_mean']:.6f} +- "
        f"{swarm['r_std']:.6f}")
    if not swarm["alive"] > 0:
        raise AssertionError("full_physics: the swarm died")
    del sim_fp
    res["pds70_gas"] = run_pds70(sim_gas)
    log_pds70(res["pds70_gas"], gpu)
    del sim_gas
    t0 = time.perf_counter()
    sim_dust = pds70(NR, NAZ, "float32", "cuda")
    log(f"  PDS70 with {sim_dust.state.particles.n} particles {NR}x{NAZ} "
        f"float32 built in {time.perf_counter() - t0:.2f} s")
    res["pds70"] = run_pds70(sim_dust)
    log_pds70(res["pds70"], gpu)
    del sim_dust
    # float64 at the same width: the swarm that float32 freezes stays alive
    res["pds70_f64"] = run_pds70(pds70(NR, NAZ, "float64", "cuda"), warmup=2,
                                 steps=5, run_steps=5)
    log_pds70(res["pds70_f64"], gpu)
    log(f"  phase 3 done at {time.perf_counter() - t_main:.1f} s")

    log("== 4. trajectory: GPU kernels vs CPU plain path")
    trajectory(256, 512, "float32", 200, 1e-3)
    trajectory(128, 256, "float64", 20, 1e-9)
    trajectory(250, 512, "float32", 200, 1e-3, setup=flagship_split)
    trajectory(130, 256, "float64", 20, 1e-9, setup=flagship_split)
    trajectory(256, 512, "float32", 200, 1e-3, setup=flagship_staged)
    trajectory(128, 256, "float64", 20, 1e-9, setup=flagship_staged)
    trajectory(64, 128, "float32", 100, 1e-3, setup=pds70_gas)
    trajectory(64, 128, "float64", 20, 1e-9, setup=pds70_gas)
    trajectory(64, 128, "float32", 100, 1e-3, setup=pds70_4096)
    trajectory(64, 128, "float64", 20, 1e-9, setup=pds70_4096)
    trajectory(256, 512, "float32", 200, 1e-3, setup=planet_disk)
    trajectory(128, 256, "float64", 20, 1e-9, setup=planet_disk)
    trajectory(256, 512, "float32", 200, 1e-3, setup=planet_torque)
    trajectory(128, 256, "float64", 20, 1e-9, setup=planet_torque)
    trajectory(128, 256, "float64", 20, 1e-9, setup=binary_gceph)
    trajectory(128, 256, "float64", 20, 1e-9,
               setup=quickstart_adiabatic_leapfrog)
    trajectory(64, 192, "float64", 20, 1e-9, setup=pds70_setup)
    trajectory(256, 512, "float32", 200, 1e-3, setup=planet_accretion)
    trajectory(128, 256, "float64", 20, 1e-9, setup=planet_accretion)
    trajectory(256, 512, "float32", 200, 1e-3, setup=star_planet)
    trajectory(128, 256, "float64", 20, 1e-9, setup=star_planet)
    trajectory(128, 256, "float64", 20, 1e-9,
               setup=binary_gcfull_golden_radii)
    trajectory(128, 256, "float64", 20, 1e-9, setup=oy_car_stream)
    trajectory(64, 128, "float64", 20, 1e-9, setup=v1504cyg, dt=V1504_DT)
    # the long tail
    trajectory(64, 128, "float64", 20, 1e-9, setup=polytropic)
    trajectory(64, 128, "float32", 100, 1e-3, setup=polytropic)
    trajectory(64, 192, "float32", 100, 1e-3, setup=planet_disk_sg)
    trajectory(32, 64, "float64", 20, 1e-9, setup=single_planet_no_disk)
    trajectory(64, 2, "float64", 20, 1e-9, setup=fld1d)
    for setup in (sigma_randomize, centrifugal_balance, secondary_disk):
        trajectory(64, 128, "float64", 20, 1e-9, setup=setup)
    binary_f32 = binary_f32_trajectory(128, 256, 20)
    newton = newton_budget(128, 384, 200)
    log(f"  phase 4 done at {time.perf_counter() - t_main:.1f} s")

    log("== 5. the command line: python -m fargocpt_torch start / restart "
        "at full size, the restart bit for bit")
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        res_cli = command_line(work, gpu)
        res_cli["gamma_cephei_full"] = binary_command_line(work, gpu)
        res_cli["oy_car"] = oy_car_command_line(work, gpu)
        res_cli["single_planet_no_disk"] = no_disk_command_line(work, gpu)
        res_cli["full_physics"] = full_physics_command_line(work, gpu)
    log(f"  phase 5 done at {time.perf_counter() - t_main:.1f} s")

    log("== 6. the reference binary's goldens on the card, float64, "
        "through the kernels and fargocpt_torch.output")
    from fargocpt_torch.flagship import shocktube_pvte
    with tempfile.TemporaryDirectory(prefix="chip_smoke_goldens_") as work:
        res_goldens = {name: golden_on_card(name, tol, work, gpu)
                       for name, tol in GOLDENS}
        res_goldens["shocktube_pvte@lookup"] = golden_on_card(
            "shocktube_pvte", 2e-4, work, gpu,
            cfg=shocktube_pvte(lookup=True), label="shocktube_pvte@lookup")
    res_goldens["shocktube_pvte_bisection"] = pvte_bisection_ms(gpu)
    log(f"  phase 6 done at {time.perf_counter() - t_main:.1f} s")

    log("== 7. the radial decomposition: ranks sharing the card over gloo")
    res_sharded = sharded_phase(gpu)
    log(f"  phase 7 done at {time.perf_counter() - t_main:.1f} s")

    # launches: each kernel's count from the run of its own path in phase 3
    # (KERNELS: the whole route for cfl, sources and viscous_kick as well,
    # the PDS70 gas step for artvisc_sn)
    kernels = [{"name": name, "route": "cuda",
                "source": f"fargocpt_torch/csrc/{name}.cu",
                "replaces": KERNELS[name][0],
                "launches": res[KERNELS[name][1]]["launches"][name],
                **{k: v for k, v in measured[name].items()
                   if k != "per_launch"}}
               for name in K.OPS]
    for k in kernels:
        if not k["launches"] > 0:
            raise AssertionError(f"kernel {k['name']} was not launched on "
                                 "its path")
    log(json.dumps({"pvte_newton_1_vs_3_rel_l2": newton,
                    "binary_gcfull_f32_vs_f64_rel_l2": binary_f32,
                    "planet_disk_isothermal_kernels": {
                        name: {k: v for k, v in m.items()
                               if k != "per_launch"}
                        for name, m in measured_planet.items()},
                    "ias15": ias15_res,
                    "leapfrog_interfaces": measured_leapfrog,
                    "goldens": res_goldens,
                    "launch_by_launch": {
                        name: m["per_launch"] for name, m in measured.items()
                        if "per_launch" in m},
                    f"transport_routes_ms_at_{NR_SPLIT}": route_ms,
                    f"transport_routes_ms_at_{NR}": route3_ms,
                    f"step_ms_in_turns_at_{NR_SPLIT}": turns,
                    f"step_ms_in_turns_at_{NR}": turns3,
                    "command_line": res_cli,
                    "sharded": res_sharded,
                    "slices": {r: {k: v for k, v in x.items()
                                   if k != "launches"}
                               for r, x in res.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

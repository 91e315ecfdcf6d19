"""fargocpt_torch — the FargoCPT disk-hydrodynamics rebuild on PyTorch.

The same 2-D polar-grid physics as ``fargocpt_tpu`` (the JAX package kept
beside it as the reference), written for PyTorch tensors: plain tensor code
for everything that runs on the CPU, and hand-written CUDA kernels
(``csrc/``, built at first use) for the four fused ops of the time step when
the tensors live on a GPU.

Field conventions match the JAX package: sigma, energy and vaz are
(NR, NAZ) with rings 0 and NR-1 as ghosts; vrad is (NR+1, NAZ).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

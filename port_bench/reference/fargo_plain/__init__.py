"""fargo_plain: a frozen copy of the plain PyTorch physics of the
FargoCPT port, the benchmark's reference.

The 2-D polar-grid disk hydrodynamics (``sim.Simulation``, ``step.HydroStep``
and the ops they compose) in plain tensor code that runs on any device,
with no hand-written kernel: ``ops/kernels.py`` runs the plain version of
every fused op. It imports neither the port nor JAX, and nothing of the
port changes it: a change to the port is measured against this copy.
"""

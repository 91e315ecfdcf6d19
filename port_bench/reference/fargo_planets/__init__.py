"""fargo_planets: a frozen copy of the plain PyTorch physics of the
FargoCPT port for a disk with planets, the reference of the benchmark's
planet-disk configurations.

``fargo_plain`` with the bodies added: more than one body on the plain
float64 IAS15 (``nbody/ias15.py``), their potential with cubic and
thickness smoothing, the disk's pull on them and the indirect term, the
damping zones (``ops/damping.py``), TW artificial viscosity
(``ops/artvisc.py``), stellar irradiation (``ops/energy.py``) and a fixed
frame rotating at OmegaFrame. The 2-D polar-grid disk hydrodynamics
(``sim.Simulation``, ``step.HydroStep`` and the ops they compose) is plain
tensor code that runs on any device, with no hand-written kernel:
``ops/kernels.py`` runs the plain version of every fused op. It imports
neither the port nor JAX, and nothing of the port changes it: a change to
the port is measured against this copy. ``scope.refuse_outside`` names
every branch of the port that the copy lacks.
"""

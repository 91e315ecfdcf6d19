"""What the benchmark's command and its reference load: nothing of JAX or
the JAX package, and the reference nothing of the port."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "fargocpt_tpu")

PROBE = """
import json, sys, runpy
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level_modules(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_command_loads_no_jax():
    loaded = top_level_modules(
        "runpy.run_path('port_bench/run.py', run_name='probe')\n"
        "from port_bench import harness, control\n"
        "import fargocpt_torch.sim, fargocpt_torch.output, "
        "fargocpt_torch.config\n"
        "import port_bench.reference.fargo_plain.sim")
    assert "fargocpt_torch" in loaded and "port_bench" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_neither_jax_nor_the_port():
    loaded = top_level_modules(
        "import port_bench.reference.fargo_plain.sim\n"
        "import port_bench.check\n"
        "from port_bench.reference.fargo_plain.ops import eos, kernels")
    assert "port_bench" in loaded
    assert not loaded & set(FORBIDDEN + ("fargocpt_torch",))

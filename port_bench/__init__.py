"""The benchmark of the PyTorch and CUDA port, fargocpt_torch.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on one CUDA card and prints its
result as the last line of standard output (``run.py``). The harness
(``harness.py``), the comparison with the plain reference (``check.py``,
``reference/``), the traced readings (``trace.py``, ``metrics/``) and the
roofline table (``roofline.py``) are the benchmark's own; it imports the
port only to drive it, and nothing of JAX.
"""

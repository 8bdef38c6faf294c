"""The benchmark of ``rise_sdf_tpu_torch``, the PyTorch and CUDA port.

    python3 -m benchmarks.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root lists the cells; each
configuration (``configs/``), traffic mix (``traffic/``), per-layer
metric (``metrics/``) and cell's correctness limits (``limits/``) is a
file of its own that the harness finds by name.  ``yardstick/`` holds
the arithmetic later changes to the program cannot move (peaks,
rooflines, model FLOPs, the trace reduction, the comparisons) and
``reference/`` the plain PyTorch reference.
"""

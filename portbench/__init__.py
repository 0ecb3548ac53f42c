"""The benchmark of ``bilinear_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own (``configs/``, ``workloads/``,
``traffic/``, ``metrics/``), found by name. ``reference/`` is the plain
PyTorch model the answers are held to; it imports nothing of the program.
"""

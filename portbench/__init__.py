"""The benchmark of ``cudaneuralrender_torch`` on an NVIDIA H100.

Run one cell from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; each configuration, traffic mix, cell and
metric is a file of its own under this folder (``spec.py`` finds them).
"""

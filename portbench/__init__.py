"""The benchmark of ``nerf_tpu_torch``, the PyTorch and CUDA port (NVIDIA H100).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
cell, configuration, traffic mix, driver, per-layer metric, kernel label and
count lives in a file of its own here, found by its name.
"""

"""The benchmark of the PyTorch/CUDA port (``cudaraytracer_tpu_torch``):
one run of one cell is ``python3 -m benchmark.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the repository's root on a
machine with an NVIDIA GPU; ``BENCHMARK.json`` names the cells."""

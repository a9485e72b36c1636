"""nerfbench: the benchmark of hashnerf_torch, the PyTorch and CUDA port.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It is driven by data: BENCHMARK.json names each cell's configuration and
traffic, and the harness finds `configs/<name>.json`, `traffic/<name>.json`
and `metrics/<name>.py` under this folder by those names. It measures the
port alone: nothing it runs imports jax, jaxlib, flax or the JAX package
(guard.py).
"""

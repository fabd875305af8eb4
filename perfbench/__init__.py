"""The benchmark of trex_tpu_torch, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line. It imports neither JAX nor the JAX package.
"""

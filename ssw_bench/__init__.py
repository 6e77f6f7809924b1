"""The benchmark of the PyTorch and CUDA port,
``spread_spectrum_watermarking_torch``, on one NVIDIA H100.

``python3 -m ssw_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Nothing here
imports the program at import time; ``program`` is the one module that
does, when a run starts.
"""

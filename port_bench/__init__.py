"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; README.md says how it is laid
out and how to add to it.
"""

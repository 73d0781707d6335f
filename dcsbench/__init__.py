"""The benchmark of the PyTorch + CUDA port (``dcsexplorer_tpu_torch``).

Run one cell once: ``python3 dcsbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the root of the
repository names the cells, configurations and metrics.
"""

"""The benchmark of the PyTorch/CUDA port: one cell a run, driven by
BENCHMARK.json and the configuration, traffic, limit and metric files
beside it.  ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root."""

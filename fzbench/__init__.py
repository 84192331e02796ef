"""The benchmark of the PyTorch and CUDA port (``repro_torch``): FZ compress and
decompress of SDRBench-sized fields on one card. ``python3 fzbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's
root runs one cell of ``BENCHMARK.json``."""

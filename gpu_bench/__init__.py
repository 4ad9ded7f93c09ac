"""The H100 benchmark of the PyTorch port (``audio_fewshot_tpu_torch``).

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json`` at the root of the
repository; ``manifest.py`` says where each of their files lies.
"""

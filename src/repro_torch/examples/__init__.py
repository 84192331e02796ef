"""The reference's four examples (``examples/``) as runnable modules of the port:

    python -m repro_torch.examples.quickstart             # K1-K3, K5, K6 on the card
    python -m repro_torch.examples.compress_field --kind turbulent
    python -m repro_torch.examples.serve_compressed_kv --kernels   # K4, K6, K7
    python -m repro_torch.examples.train_lm --steps 60    # K5/K6 checkpoints

Each runs on the CUDA card unless ``--device cpu`` is given, and each ``main``
takes an optional ``argv`` list, so it can be called in-process.
"""

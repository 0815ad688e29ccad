"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell of
``BENCHMARK.json`` a run, driven by the files under this folder. See
``README.md``."""

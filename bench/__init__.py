"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
at a time through ``bench/run.py``; see ``bench/README.md``."""

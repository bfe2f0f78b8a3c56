"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout per kernel: <name>.py (launch wrapper, launch count, ``plain``)
over csrc/<name>.cu; ref.py holds the plain versions and ops.py the
``impl`` switch.  build.py compiles csrc/ with nvcc at first use.
"""

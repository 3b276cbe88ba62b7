"""PyTorch + CUDA port of the GPU-backed data mining system.

Mirrors :mod:`repro` module for module (``repro_torch/core/kmeans.py`` is
held against ``repro/core/kmeans.py``).  The paper's hot spots run as CUDA
kernels written by hand for Hopper (``csrc/*.cu``), built with ``nvcc`` at
first use; on CPU tensors every kernel wrapper takes its plain PyTorch
version instead.  Importing this package touches no device and imports
neither ``jax`` nor anything of :mod:`repro`.
"""

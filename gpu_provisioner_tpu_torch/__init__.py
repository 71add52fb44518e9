"""PyTorch/CUDA port of the JAX workload stack in ``gpu_provisioner_tpu``.

The JAX package stays the reference; each module here has a twin at the
same relative path there and is tested against it on the same inputs.
This package imports torch and numpy, never jax and nothing of
``gpu_provisioner_tpu``. Its kernels are CUDA C++ for Hopper (sm_90a)
under ``ops/csrc/``, built with nvcc at first use.
"""

from .device import prime_cpu_math

prime_cpu_math()

"""Attention kernels (CUDA C++ for Hopper) with their plain versions.

Twin of ``gpu_provisioner_tpu/ops/``. Unlike it, this package does not
re-export ``flash_attention``, so the name stays the module's.
"""

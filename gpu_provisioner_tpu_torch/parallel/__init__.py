"""Single-device attention twins of ``gpu_provisioner_tpu/parallel``."""

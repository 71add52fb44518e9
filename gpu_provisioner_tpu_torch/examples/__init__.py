"""Workload examples of the port, twins of ``examples/workloads/``."""

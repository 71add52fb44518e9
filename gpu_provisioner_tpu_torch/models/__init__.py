"""Llama serving: model, KV-cache decode and the continuous-batching engine.

Twins of the dense serving modules of ``gpu_provisioner_tpu/models/``
(``llama``, ``decode``, ``engine``); MoE, speculation, training and
checkpointing are not ported yet.
"""

"""Llama serving and single-device training: model, KV-cache decode, the
continuous-batching engine and the train step.

Twins of the dense modules of ``gpu_provisioner_tpu/models/`` (``llama``,
``decode``, ``engine``, ``train``); MoE, speculation, the sharded train
steps and checkpointing are not ported yet.
"""

"""Llama and MoE serving and single-device training: models, KV-cache
decode, the continuous-batching engine and the train step.

Twins of ``gpu_provisioner_tpu/models/`` ``llama``, ``decode``, ``engine``,
``train``, ``moe`` and ``moe_serve``; speculation, the sharded and MoE
train steps and checkpointing are not ported yet.
"""

"""Llama and MoE serving and single-device training: models, KV-cache
decode, speculative decoding, the continuous-batching engine and the train
step.

Twins of ``gpu_provisioner_tpu/models/`` ``llama``, ``decode``,
``speculative``, ``engine``, ``train``, ``moe`` and ``moe_serve``; the
sharded and MoE train steps and checkpointing are not ported yet.
"""

from .speculative import speculative_generate

__all__ = ["speculative_generate"]

"""Llama and MoE serving and training: models, KV-cache
decode, speculative decoding, the continuous-batching engine, the dense
and MoE train steps and train-state checkpointing.

Twins of ``gpu_provisioner_tpu/models/`` ``llama``, ``decode``,
``speculative``, ``engine``, ``train``, ``moe``, ``moe_serve`` and
``checkpoint``; the dense train step also runs sharded (data, sequence and
tensor parallelism) and pipelined, the MoE train step expert-parallel.
"""

from .speculative import speculative_generate

__all__ = ["speculative_generate"]

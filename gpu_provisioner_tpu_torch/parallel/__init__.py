"""Twins of ``gpu_provisioner_tpu/parallel``: topology and bootstrap
(labels → a ``torch.distributed`` process group and a ``DeviceMesh``), ring
and zigzag attention over the ``seq`` axis, and the port's own collectives
(``comm``) and launcher (``launch``, ``jobs``). The pipeline is not ported
yet."""

"""Twins of ``gpu_provisioner_tpu/parallel``: topology and bootstrap
(labels → a ``torch.distributed`` process group and a ``DeviceMesh``), ring
and zigzag attention over the ``seq`` axis, the pipeline's schedules over
``pipe`` (``pipeline``: gpipe and interleaved), and the port's own
collectives (``comm``) and launcher (``launch``, ``jobs``)."""

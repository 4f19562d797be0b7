"""Meshes and sharding over ``torch.distributed`` — counterpart of
``mlrun_tpu/parallel``: ``mesh.py`` and ``sharding.py``, the tensor axis
and per-layer ``fsdp`` gather of the sharded step (``tensor.py``), and
GPipe stages over a ``pipe`` axis (``pipeline.py``)."""

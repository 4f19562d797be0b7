"""Meshes and sharding over ``torch.distributed`` — counterpart of
``mlrun_tpu/parallel`` (``mesh.py``, ``sharding.py``). Pipeline
parallelism (``pipeline.py``) is not ported yet (ROADMAP.md item 7)."""

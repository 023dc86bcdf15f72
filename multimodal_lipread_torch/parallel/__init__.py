"""Multi-GPU training and serving: process groups (``distributed.py``),
meshes and partition rules (``mesh.py``) and GPipe (``pipeline.py``)."""

"""The benchmark of the PyTorch and CUDA port (``multimodal_lipread_torch``):
see ``README.md`` in this directory."""

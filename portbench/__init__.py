"""The benchmark of ``scarlet_tpu_torch``, the PyTorch and CUDA port: cells
of the lite device stream on one card (README.md)."""

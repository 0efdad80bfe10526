"""models of the PyTorch port (counterpart of stencil_tpu/models)."""

"""Front-end state, filter state and the per-frame filter step (PyTorch
counterparts of ``larvio_tpu.models``)."""

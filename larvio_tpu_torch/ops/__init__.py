"""Image-plane ops of the front-end (PyTorch counterparts of ``larvio_tpu.ops``)."""

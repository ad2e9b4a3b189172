"""Core numerics: JPL quaternion algebra, SO(3), camera models, chi-square
tables and the filter's dense linear algebra (PyTorch counterparts of
``larvio_tpu.core``)."""

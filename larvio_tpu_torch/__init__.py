"""larvio_tpu_torch — the PyTorch + CUDA port of the larvio_tpu VIO pipeline.

Mirrors the layout of the JAX package ``larvio_tpu`` (``core/``, ``ops/``,
``models/``, ``data/``, ``pipeline.py``) so each module's counterpart sits at
the same relative path. Plain tensor code is PyTorch; the two Pallas kernels
of the image-to-pose main path (pyramidal LK and ORB slab extraction) are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use and
bound through ``ctypes``. A wrapper dispatches on the tensor's device: CPU
tensors take the plain PyTorch version, CUDA tensors take the kernel.

Covered: the pure-MSCKF configuration (``FilterConfig.max_slam_features ==
0``). The configuration schema, the simulator and the ATE evaluation are
imported from the JAX package's numpy-only modules, never copied, so both
packages read one ``VioConfig``. Nothing here imports JAX.
"""

__version__ = "0.1.0"

from larvio_tpu.config import (  # noqa: F401
    CameraConfig,
    FilterConfig,
    FrontendConfig,
    NoiseConfig,
    VioConfig,
)

"""larvio_tpu_torch — the PyTorch + CUDA port of the larvio_tpu VIO pipeline.

Mirrors the layout of the JAX package ``larvio_tpu`` (``core/``, ``ops/``,
``models/``, ``data/``, ``parallel/``, ``pipeline.py``) so each module's
counterpart sits at the same relative path. Plain tensor code is PyTorch; the
Pallas kernels of the image-to-pose path (pyramidal LK, single and batched,
and ORB slab extraction) are hand-written CUDA C++ under ``csrc/``, built
with ``nvcc`` at first use and bound through ``ctypes``. A wrapper dispatches
on the tensor's device: CPU tensors take the plain PyTorch version, CUDA
tensors take the kernel.

Covered: the hybrid SLAM/MSCKF filter in square-root covariance form (the
default ``VioConfig``, and the pure-MSCKF ``max_slam_features == 0``), one
instance or a fleet of B independent instances (every state leaf with a
leading instance axis, ``parallel/fleet.py``). The configuration
schema, the simulator and the ATE evaluation are the port's own modules
(``config``, ``data.sim``, ``data.evaluate``). Nothing here imports JAX or
the JAX package.
"""

__version__ = "0.2.0"

from larvio_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    FilterConfig,
    FrontendConfig,
    NoiseConfig,
    VioConfig,
)

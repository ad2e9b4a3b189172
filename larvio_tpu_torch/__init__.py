"""larvio_tpu_torch — the PyTorch + CUDA port of the larvio_tpu VIO pipeline.

Mirrors the layout of the JAX package ``larvio_tpu`` (``core/``, ``ops/``,
``models/``, ``init/``, ``data/``, ``parallel/``, ``utils/``, ``pipeline.py``,
``api.py``, ``cli.py``) so each module's counterpart sits at the same
relative path. Plain tensor code is PyTorch; the Pallas kernels of the
image-to-pose path (pyramidal LK, single and batched, and ORB slab
extraction, fused with the descriptor) are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use and bound through ``ctypes``. A
wrapper dispatches on the tensor's device: CPU tensors take the plain
PyTorch version, CUDA tensors take the kernel.

Covered: the hybrid SLAM/MSCKF filter in square-root covariance form (the
default ``VioConfig``, and the pure-MSCKF ``max_slam_features == 0``) and in
Joseph (dense covariance) form (``FilterConfig(sqrt_form=False)``), one
instance or a fleet of B independent instances on one card (every state leaf
with a leading instance axis, ``parallel/fleet.py``), and the user's entry
point: ``python -m larvio_tpu_torch.cli {run,sim,export-sim}`` (EuRoC reader
with its own PNG codec, TUM output, checkpoint/resume, the host's in-motion
initializer, ``--plot`` / ``--live`` figures drawn by a numpy rasteriser,
``--debug-nans``), ``api.py`` and ``pipeline.run_image_sequence_flexible``;
the jitted entry points (``pipeline.jit_pipeline_step``, ``api.step``,
``parallel/fleet.py::jit_fleet_step``) and every runner replaying one CUDA
graph per signature from ``core/graph.py::CACHE``, jit's compile-once
cache;
the sharded fleet over ``torch.distributed`` (its step replayed as one CUDA
graph on NCCL); the diagnostics: the twelve stage regions of the step
(``core/stages.py``, summed per stage by ``tools/torch_trace_analyze.py``)
and ``track_frame(debug=True)``; the native EuRoC CSV loader and IMU ring
(``utils/native.py``). The configuration schema, the simulator, the ATE
evaluation and the host initialization code are the port's own modules.
Nothing here imports JAX, the JAX package, cv2, matplotlib or PIL.
"""

__version__ = "0.2.0"

from larvio_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    FilterConfig,
    FrontendConfig,
    NoiseConfig,
    VioConfig,
)

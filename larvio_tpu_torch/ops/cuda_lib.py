"""Build and bind the hand-written CUDA kernels (``larvio_tpu_torch/csrc``).

The kernels are compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ONE shared library with a
plain C interface, under ``larvio_tpu_torch/_build/`` (git-ignored), and
loaded with ``ctypes``. The library name carries a hash of the sources and
flags, so an edited kernel rebuilds and an unchanged one is reused. Nothing
here runs at import time: this module imports on hosts without ``nvcc``.
A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_info: dict = {}  # {"path", "seconds", "log", "reused"} of the last build


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (or reuse an up-to-date one)."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"liblarvio_kernels_{h.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # concurrent processes build once
        if out.exists():
            build_info.update(path=str(out), seconds=time.perf_counter() - t0, log="", reused=True)
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0,
        log=(proc.stdout + proc.stderr).strip(), reused=False,
    )
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.larvio_lk_track_batched.argtypes = [
            vp, vp, vp, vp, vp, vp, i32,  # image pointer arrays, heights, widths, levels
            i32, vp, vp, vp, i32,  # lanes, pos, guess, valid, n_feat per lane
            i32, i32, f32, f32, f32,  # patch, iters, precision^2, max_err, min_eig
            vp, vp, vp, vp,  # out_pos, out_valid, out_err, stream
        ]
        lib.larvio_lk_track_batched.restype = i32
        lib.larvio_orb_describe.argtypes = [
            vp, i32, i32, i32,  # img, lanes, H, W
            vp, vp, i32, vp, vp, vp,  # pos, valid, n_feat per lane, pattern, out, stream
        ]
        lib.larvio_orb_describe.restype = i32
        i64 = ctypes.c_longlong
        lib.larvio_lane_mm.argtypes = [
            vp, vp, vp, i32, vp, vp, vp,  # A, B, C, leading axes: sizes, A's strides, B's strides
            i32, i32, i32, i64, i64, i64, i64,  # M, N, K, A's row/col strides, B's row/col strides
            i32, i32, i32, vp,  # the shape class, a tiled block's ty x tx threads, stream
        ]
        lib.larvio_lane_mm.restype = i32
        lib.larvio_lane_trsm.argtypes = [
            vp, vp, vp, i32, vp, vp, vp,  # A, B, X, leading axes: sizes, A's strides, B's strides
            i32, i32, i32, i64, i64, i64, i64,  # n, W, upper, A's and B's row/col strides
            i32, vp,  # columns of X per block, stream
        ]
        lib.larvio_lane_trsm.restype = i32
        lib.larvio_detect_corners.argtypes = [
            vp, i32, i32, i32,  # image, lanes, H, W
            i32, i32, i32, i32, i32,  # grid rows, grid cols, k, border, NMS radius
            vp, vp, vp,  # scores, xy, stream
        ]
        lib.larvio_detect_corners.restype = i32
        lib.larvio_pyr_down.argtypes = [vp, i32, i32, i32, vp, vp]  # src, lanes, H, W, dst, stream
        lib.larvio_pyr_down.restype = i32
        lib.larvio_scharr_pyramid.argtypes = [
            vp, vp, vp, vp, vp, i32,  # pointer arrays: images, gx, gy; heights, widths, levels
            i32, vp,  # lanes, stream
        ]
        lib.larvio_scharr_pyramid.restype = i32
        _lib = lib
    return _lib


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from larvio_tpu_torch.ops.detect_cuda import detect_corners
    from larvio_tpu_torch.ops.lane_mm_cuda import lane_mm, lane_solve_triangular
    from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
    from larvio_tpu_torch.ops.orb import describe
    from larvio_tpu_torch.ops.pyramid_cuda import build_pyramid, grad_pyramid

    return {"lk_track": lk_track_cuda.launches, "lk_track_batched": lk_track_cuda.launches_batched,
            "orb_describe": describe.launches, "orb_describe_batched": describe.launches_batched,
            "lane_mm": lane_mm.launches, "lane_trsm": lane_solve_triangular.launches,
            "detect_corners": detect_corners.launches,
            "detect_corners_batched": detect_corners.launches_batched,
            "pyr_down": build_pyramid.launches, "pyr_down_batched": build_pyramid.launches_batched,
            "scharr": grad_pyramid.launches, "scharr_batched": grad_pyramid.launches_batched}


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def ptr_array(tensors):
    """Host array of device pointers (ctypes passes it as a void*)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def int64_array(values):
    return (ctypes.c_longlong * max(len(values), 1))(*[int(v) for v in values])

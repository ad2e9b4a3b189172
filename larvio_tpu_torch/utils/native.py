"""The port's native host code (port of ``larvio_tpu/utils/native.py``):
``load_csv`` and ``ImuRing`` over ``csrc/euroc_loader.cpp``, and
``host_library``, which builds a C or C++ source of ``csrc/`` with the
host's compiler into ``larvio_tpu_torch/_build/`` at first use (also for
``data/png.py``'s ``csrc/png_unfilter.c``).

A library's name carries a hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused; concurrent processes build once. A
failed build raises: unlike the JAX package's callers, nothing falls back to
numpy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
_CSV_SRC = _PKG / "csrc" / "euroc_loader.cpp"
HOST_FLAGS = ["-O3", "-shared", "-fPIC"]
_libs: dict = {}


def _compiler(cxx: bool) -> str:
    env, names = ("CXX", ("c++", "g++")) if cxx else ("CC", ("cc", "gcc"))
    for c in (os.environ.get(env), *map(shutil.which, names)):
        if c and shutil.which(c):
            return c
    raise RuntimeError(f"no {'C++' if cxx else 'C'} compiler ({' / '.join(names)}, or ${env}) "
                       f"to build the port's host code")


def host_library(src: Path, flags=None) -> ctypes.CDLL:
    """``src`` (``.c`` or ``.cpp``) built with ``flags`` (default
    ``HOST_FLAGS``) into a shared library and loaded, once per process;
    raises if the build fails."""
    flags = HOST_FLAGS if flags is None else flags
    key = (str(src), tuple(flags))
    if key not in _libs:
        h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{src.stem}_{h}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{src.stem}_build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # concurrent processes build once
            if not out.exists():
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [_compiler(src.suffix == ".cpp"), *flags, "-o", str(tmp), str(src)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{'C++' if src.suffix == '.cpp' else 'C'} build failed "
                                       f"({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, out)
        _libs[key] = ctypes.CDLL(str(out))
    return _libs[key]


def _csv_lib() -> ctypes.CDLL:
    lib = host_library(_CSV_SRC)
    vp, i64, f64 = ctypes.c_void_p, ctypes.c_long, ctypes.c_double
    lib.euroc_csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.euroc_csv_count_rows.restype = i64
    lib.euroc_csv_load.argtypes = [ctypes.c_char_p, ctypes.c_int, vp, i64]
    lib.euroc_csv_load.restype = i64
    lib.imu_ring_create.argtypes = [i64]
    lib.imu_ring_create.restype = vp
    lib.imu_ring_destroy.argtypes = [vp]
    lib.imu_ring_destroy.restype = None
    lib.imu_ring_push.argtypes = [vp, f64, vp, vp]
    lib.imu_ring_push.restype = None
    lib.imu_ring_bucket.argtypes = [vp, f64, f64, f64, i64, vp, vp, vp, vp]
    lib.imu_ring_bucket.restype = i64
    return lib


def load_csv(path: str, n_cols: int) -> np.ndarray:
    """The first ``n_cols`` numeric fields of every data row of a CSV file
    (rows starting with ``#`` and blank rows skipped; ``\\r\\n`` endings and
    ``nan`` read as ``np.loadtxt`` reads them) as a (rows, n_cols) float64
    array. A row with fewer fields is skipped."""
    if n_cols < 1:
        raise ValueError(f"n_cols must be >= 1, got {n_cols}")
    lib = _csv_lib()
    n = lib.euroc_csv_count_rows(os.fsencode(path))
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, n_cols), np.float64)
    got = lib.euroc_csv_load(os.fsencode(path), n_cols, out.ctypes.data, n)
    if got < 0:
        raise OSError(f"native csv load failed: {path}")
    return out[:got]


class ImuRing:
    """Streaming IMU synchronizer: a native ring buffer of the newest
    ``capacity`` samples, and per camera frame a fixed-slot padded bucket
    in the layout ``models/propagation.py`` expects (slot 0 the sample at or
    before the previous frame, then the samples up to ``margin`` past the
    frame)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lib = _csv_lib()
        self._h = self._lib.imu_ring_create(capacity)

    def push(self, t: float, w: np.ndarray, a: np.ndarray) -> None:
        w = np.ascontiguousarray(w, np.float64).reshape(3)
        a = np.ascontiguousarray(a, np.float64).reshape(3)
        self._lib.imu_ring_push(self._h, float(t), w.ctypes.data, a.ctypes.data)

    def bucket(self, t_prev: float, t_img: float, slots: int, margin: float = 0.04):
        """(t (slots,) f32, w (slots, 3) f32, a (slots, 3) f32, valid (slots,) bool)."""
        t = np.zeros(slots, np.float32)
        w = np.zeros((slots, 3), np.float32)
        a = np.zeros((slots, 3), np.float32)
        v = np.zeros(slots, np.uint8)
        self._lib.imu_ring_bucket(self._h, float(t_prev), float(t_img), float(margin), slots,
                                  t.ctypes.data, w.ctypes.data, a.ctypes.data, v.ctypes.data)
        return t, w, a, v.astype(bool)

    def close(self) -> None:
        """Free the native buffer (also done when the ring is collected)."""
        if getattr(self, "_h", None):
            self._lib.imu_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

"""8-bit grayscale PNG files with the standard library's ``zlib`` and numpy.

The JAX package reads and writes the EuRoC images with ``cv2``; the port
reads them here, so the dataset path needs no OpenCV. Only what EuRoC
sequences hold is read: 8-bit grayscale (colour type 0), not interlaced, all
five row filters (None, Sub, Up, Average, Paeth). Any other file raises.

Each filtered row adds a prediction to the stored bytes, modulo 256, from
the pixel on the left, the one above or the upper-left one. Average and Paeth
rows (what adaptive writers, and so real EuRoC files, produce) need each
pixel's left neighbour's final value, a serial chain: every file is
unfiltered by ``csrc/png_unfilter.c``, one pass in C built with the host's C
compiler at first use into ``larvio_tpu_torch/_build/`` and called through
``ctypes`` (which releases the interpreter lock, so prefetch threads decode
beside the dispatching one). A failed build raises, and so does an unknown
row filter. ``_unfilter_wavefront`` is the numpy version the tests hold it
to: every pixel (r, c) with r + c = d depends only on diagonals d - 1 and
d - 2, so each of the H + W - 1 steps decodes a whole diagonal.

The writer filters every row with Up (the row minus the row above).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_NONE, _SUB, _UP, _AVERAGE, _PAETH = range(5)
_PKG = Path(__file__).resolve().parent.parent
_C_SRC = _PKG / "csrc" / "png_unfilter.c"
_C_FLAGS = ["-O2", "-shared", "-fPIC"]
_lib = None


def _c_compiler() -> str:
    for c in (os.environ.get("CC"), shutil.which("cc"), shutil.which("gcc")):
        if c and shutil.which(c):
            return c
    raise RuntimeError("no C compiler (cc / gcc, or $CC) to build csrc/png_unfilter.c")


def _unfilter_lib() -> ctypes.CDLL:
    """The unfilter library, built on first call (reused while the source
    and flags are unchanged)."""
    global _lib
    if _lib is None:
        h = hashlib.sha256(" ".join(_C_FLAGS).encode() + _C_SRC.read_bytes()).hexdigest()[:16]
        build = _PKG / "_build"
        out = build / f"libpng_unfilter_{h}.so"
        build.mkdir(parents=True, exist_ok=True)
        with open(build / "png_build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # concurrent processes build once
            if not out.exists():
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [_c_compiler(), *_C_FLAGS, "-o", str(tmp), str(_C_SRC)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"C build failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.larvio_png_unfilter.argtypes = [vp, vp, i32, i32, vp]
        lib.larvio_png_unfilter.restype = i32
        _lib = lib
    return _lib


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _chunks(data: bytes):
    """(kind, body) of each chunk up to IEND, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc_at = pos + 8 + n
        if len(body) != n or crc_at + 4 > len(data):
            break
        if zlib.crc32(kind + body) != struct.unpack(">I", data[crc_at:crc_at + 4])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError("truncated PNG: no IEND chunk")


def decode_png_gray(data: bytes) -> np.ndarray:
    """The (H, W) uint8 image of an 8-bit grayscale, non-interlaced PNG."""
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, colour, compression, filtering, interlace = header
    if colour != 0 or depth != 8:
        raise ValueError(f"only 8-bit grayscale PNGs are read (colour type {colour}, bit depth {depth})")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG (compression {compression}, filter method "
                         f"{filtering}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {H * (W + 1)} expected")
    raw = raw.reshape(H, W + 1)
    return _unfilter_c(raw[:, 1:], raw[:, 0])


def _unfilter_c(rows: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, one serial pass in C; an unknown filter raises."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    ftype = np.ascontiguousarray(ftype, dtype=np.uint8)
    H, W = rows.shape
    out = np.empty((H, W), np.uint8)
    bad = _unfilter_lib().larvio_png_unfilter(rows.ctypes.data, ftype.ctypes.data, H, W, out.ctypes.data)
    if bad:
        raise ValueError(f"unknown PNG row filter {int(ftype[bad - 1])}")
    return out


def _unfilter_wavefront(rows: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal per step.

    ``S[d + 2, r + 1]`` holds pixel (r, d - r): its left neighbour is
    ``S[d + 1, r + 1]``, the one above ``S[d + 1, r]`` and the upper-left one
    ``S[d, r]``. Row 0 and the first two diagonals of S are zero padding, and
    cells left of column 0 are never written, so the image's border reads 0
    as the PNG specification asks."""
    H, W = rows.shape
    r_idx, c_idx = np.indices((H, W))
    raw = np.zeros((H + W - 1, H), np.int16)
    raw[r_idx + c_idx, r_idx] = rows
    S = np.zeros((H + W + 1, H + 1), np.int16)
    is_paeth, is_avg, is_up, is_sub = (ftype == k for k in (_PAETH, _AVERAGE, _UP, _SUB))
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H - 1, d) + 1
        a = S[d + 1, lo + 1:hi + 1]
        b = S[d + 1, lo:hi]
        c = S[d, lo:hi]
        pa, pb = np.abs(b - c), np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_paeth[lo:hi], paeth,
                        np.where(is_avg[lo:hi], (a + b) >> 1,
                                 np.where(is_up[lo:hi], b, np.where(is_sub[lo:hi], a, 0))))
        S[d + 2, lo + 1:hi + 1] = (raw[d, lo:hi] + pred) & 0xFF
    return S[r_idx + c_idx + 2, r_idx + 1].astype(np.uint8)


def encode_png_gray(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) uint8 image, every row filtered with Up."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"an (H, W) uint8 image is written, not {img.dtype} {img.shape}")
    H, W = img.shape
    raw = np.empty((H, W + 1), np.uint8)
    raw[:, 0] = _UP
    raw[0, 1:] = img[0]
    raw[1:, 1:] = img[1:] - img[:-1]  # uint8: modulo 256
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """The (H, W) uint8 image of the PNG file at ``path``."""
    with open(path, "rb") as f:
        return decode_png_gray(f.read())


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as a PNG file."""
    data = encode_png_gray(img)
    with open(path, "wb") as f:
        f.write(data)

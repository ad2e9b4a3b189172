"""EuRoC ASL dataset reader (port of ``larvio_tpu/data/euroc.py``).

Reads ``mav0/cam0/data.csv`` and its PNGs, ``mav0/imu0/data.csv`` and, where
present, ``mav0/state_groundtruth_estimate0/data.csv``. Host-side numpy: the
per-frame IMU bucketing produces the padded ``ImuBatch`` layout the pipeline
consumes (slot 0 = the sample at or before the previous frame so propagation
can seed its interval, then the samples up to 0.04 s past the frame for
online time-offset propagation). The CSVs are parsed in C++
(``utils/native.py::load_csv``, as the JAX package's native loader does),
the images with ``data/png.py``; images stay uint8 until ``pipeline_step`` casts them on
the device.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.data.png import read_png_gray
from larvio_tpu_torch.utils.native import load_csv


def _load_csv(path: str, n_cols: int) -> np.ndarray:
    return load_csv(path, n_cols)


class EurocSequence:
    """One EuRoC ASL sequence directory (the folder containing mav0/)."""

    def __init__(self, root: str, cam: str = "cam0", imu: str = "imu0"):
        mav = os.path.join(root, "mav0") if os.path.isdir(os.path.join(root, "mav0")) else root
        self.cam_dir = os.path.join(mav, cam, "data")
        cam_csv = os.path.join(mav, cam, "data.csv")
        imu_csv = os.path.join(mav, imu, "data.csv")
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")

        # image stamps name the PNG files: parse as exact int64 (EuRoC ns
        # stamps ~1.4e18 exceed float64's 2^53 integer range)
        stamps = []
        with open(cam_csv) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                stamps.append(int(line.split(",")[0]))
        self.image_stamps = np.sort(np.array(stamps, np.int64))
        imu_data = _load_csv(imu_csv, 7)
        imu_data = imu_data[np.argsort(imu_data[:, 0])]
        self.imu_t = imu_data[:, 0].astype(np.int64)
        self.imu_w = imu_data[:, 1:4].astype(np.float32)
        self.imu_a = imu_data[:, 4:7].astype(np.float32)

        self.gt = None
        if os.path.exists(gt_csv):
            g = _load_csv(gt_csv, 8)
            self.gt = {
                "t": g[:, 0].astype(np.int64),
                "p": g[:, 1:4].astype(np.float64),
                "q_wxyz": g[:, 4:8].astype(np.float64),
            }

        # common clock origin so f32 timestamps keep microsecond resolution
        self.t0 = int(min(self.image_stamps[0], self.imu_t[0]))

    def _sec(self, ns: np.ndarray) -> np.ndarray:
        return ((np.asarray(ns) - self.t0) * 1e-9).astype(np.float64)

    def load_image(self, stamp_ns: int) -> np.ndarray:
        """The (H, W) uint8 image of one stamp."""
        return read_png_gray(os.path.join(self.cam_dir, f"{stamp_ns}.png"))

    def frames(self, cfg: VioConfig, max_frames: Optional[int] = None,
               skip_frames: int = 0, lazy: bool = False) -> Iterator[dict]:
        """Yield per-frame dicts: image + padded ImuBatch arrays + t_img.

        lazy=True yields "image" as a zero-arg callable instead of the decoded
        array, so the CLI's prefetcher can decode on a thread pool."""
        S = cfg.filter.imu_slots_per_frame
        imu_sec = self._sec(self.imu_t)
        stamps = self.image_stamps[skip_frames:]
        if max_frames:
            stamps = stamps[:max_frames]
        t_prev = 0.0
        for ns in stamps:
            t_img = float(self._sec(ns))
            # samples: one at/before t_prev (interval seed) .. margin past t_img
            lo = np.searchsorted(imu_sec, t_prev, side="right") - 1
            hi = np.searchsorted(imu_sec, t_img + 0.04, side="right")
            lo = max(lo, 0)
            sel = slice(lo, min(hi, lo + S))
            n = sel.stop - sel.start
            it = np.zeros(S, np.float32)
            iw = np.zeros((S, 3), np.float32)
            ia = np.zeros((S, 3), np.float32)
            iv = np.zeros(S, bool)
            it[:n] = imu_sec[sel]
            iw[:n] = self.imu_w[sel]
            ia[:n] = self.imu_a[sel]
            iv[:n] = True
            yield {
                "image": (lambda s=int(ns): self.load_image(s)) if lazy else self.load_image(int(ns)),
                "imu_t": it,
                "imu_w": iw,
                "imu_a": ia,
                "imu_valid": iv,
                "t_img": np.float32(t_img),
            }
            t_prev = t_img

    def ground_truth_at(self, t_sec: np.ndarray) -> np.ndarray:
        """Interpolated ground-truth positions at the given times."""
        if self.gt is None:
            raise ValueError("sequence has no ground truth")
        gt_t = self._sec(self.gt["t"])
        return np.stack([np.interp(t_sec, gt_t, self.gt["p"][:, i]) for i in range(3)], axis=-1)

"""Run-summary figure, drawn by a numpy rasteriser and written by the port's
own PNG writer (port of ``larvio_tpu/data/visualize.py``, which draws with
matplotlib; the port needs neither matplotlib nor PIL).

The panels are the JAX figure's, in its grid and colours: top-down (x-y,
equal axes) and altitude (z-t) against ground truth when given, the
position error against ground truth (or the distance from the origin), the
tracked features on the last frame, and the estimator-health and events
strips when ``stats`` is given. The figure is 1210 px wide and 352 px per
row (matplotlib's (11, 3.2 rows) inches at 110 dpi). Each panel has a frame
and a light grid at round data values; there is no text: the title goes into
the PNG's ``Title`` tEXt chunk.
"""

from __future__ import annotations

import numpy as np

from larvio_tpu_torch.data.png import write_png_rgb

FIG_W, ROW_H = 1210, 352
MARGIN = (48, 28, 16, 30)  # left, top, right, bottom of each panel's data box, px
FRAME, GRID = (0, 0, 0), (230, 230, 230)
C_EST, C_GT, C_START = "#1f77b4", "#555555", "#008000"  # matplotlib's "green"
C_ERR, C_FEAT = "#d62728", "#2ca02c"
C_HEALTH = (("tracks", "#1f77b4"), ("clones", "#ff7f0e"), ("updated", "#2ca02c"))
C_EVENTS = (("zupt", "#9467bd"), ("resets", "#d62728"))


def rgb(hex_colour: str) -> tuple:
    """(r, g, b) of a ``#rrggbb`` colour."""
    return tuple(int(hex_colour[i:i + 2], 16) for i in (1, 3, 5))


def _nice_step(span: float, n: int = 5) -> float:
    raw = span / n
    mag = 10.0 ** np.floor(np.log10(raw))
    return float(mag * min((1, 2, 5, 10), key=lambda m: abs(m * mag - raw)))


class Axes:
    """One panel: a data box of the canvas and its data limits. ``px(x, y)``
    maps data to (column, row) pixel coordinates."""

    def __init__(self, img: np.ndarray, box, x, y, equal: bool = False, ylim=None):
        self.img = img
        x0, y0, x1, y1 = box
        self.box = (x0 + MARGIN[0], y0 + MARGIN[1], x1 - MARGIN[2], y1 - MARGIN[3])
        self.xlim = self._limits(x)
        self.ylim = ylim if ylim is not None else self._limits(y)
        if equal:  # one data unit spans as many pixels on both axes
            bw, bh = self.box[2] - self.box[0], self.box[3] - self.box[1]
            scale = max((self.xlim[1] - self.xlim[0]) / bw, (self.ylim[1] - self.ylim[0]) / bh)
            cx, cy = sum(self.xlim) / 2, sum(self.ylim) / 2
            self.xlim = (cx - scale * bw / 2, cx + scale * bw / 2)
            self.ylim = (cy - scale * bh / 2, cy + scale * bh / 2)

    @staticmethod
    def _limits(v):
        v = np.asarray(v, np.float64)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return (0.0, 1.0)
        lo, hi = float(v.min()), float(v.max())
        pad = 0.05 * (hi - lo) if hi > lo else max(abs(lo), 1.0) * 0.05
        return (lo - pad, hi + pad)

    def px(self, x, y):
        x0, y0, x1, y1 = self.box
        u = x0 + (np.asarray(x, np.float64) - self.xlim[0]) / (self.xlim[1] - self.xlim[0]) * (x1 - x0)
        v = y1 - (np.asarray(y, np.float64) - self.ylim[0]) / (self.ylim[1] - self.ylim[0]) * (y1 - y0)
        return u, v

    def _put(self, u, v, colour) -> None:
        u, v = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
        x0, y0, x1, y1 = self.box
        m = (u >= x0) & (u <= x1) & (v >= y0) & (v <= y1)
        self.img[v[m], u[m]] = colour

    def _segments(self, u, v, width: int, colour, dash=None) -> None:
        """Polyline through (u, v) px, sampled every ~0.5 px; ``dash``: (on,
        off) lengths in px along the line."""
        ok = np.isfinite(u) & np.isfinite(v)
        u, v = u[ok], v[ok]
        if u.size == 1:
            u, v = np.repeat(u, 2), np.repeat(v, 2)
        if u.size < 2:
            return
        du, dv = np.diff(u), np.diff(v)
        n = np.maximum(np.ceil(2 * np.maximum(np.abs(du), np.abs(dv))).astype(np.int64), 1)
        seg = np.repeat(np.arange(n.size), n)
        frac = (np.arange(seg.size) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n, n)
        su = np.append(u[seg] + frac * du[seg], u[-1])
        sv = np.append(v[seg] + frac * dv[seg], v[-1])
        if dash is not None:
            step = np.append(np.hypot(du, dv)[seg] / np.repeat(n, n), 0.0)
            arc = np.cumsum(step) - step
            keep = (arc % (dash[0] + dash[1])) < dash[0]
            su, sv = su[keep], sv[keep]
        r = (width - 1) / 2
        for a in np.arange(-r, r + 1):
            for b in np.arange(-r, r + 1):
                self._put(su + a, sv + b, colour)

    def plot(self, x, y, colour: str, width: int = 1, dash=None) -> None:
        self._segments(*self.px(x, y), width, rgb(colour), dash)

    def markers(self, x, y, colour: str, radius: float = 3.0, filled: bool = True) -> None:
        u, v = self.px(x, y)
        ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        rs = np.arange(0.0, radius + 0.5, 0.5) if filled else np.array([radius])
        for r in rs:
            self._put((u[:, None] + r * np.cos(ang)).ravel(), (v[:, None] + r * np.sin(ang)).ravel(),
                      rgb(colour))

    def image(self, frame: np.ndarray) -> None:
        """A grayscale (H, W) frame in [0, 255] filling the box at its own
        aspect (nearest pixel); the data coordinates become the frame's."""
        H, W = frame.shape
        x0, y0, x1, y1 = self.box
        s = min((x1 - x0) / W, (y1 - y0) / H)
        w, h = int(W * s), int(H * s)
        ox, oy = x0 + (x1 - x0 - w) // 2, y0 + (y1 - y0 - h) // 2
        rows = np.minimum((np.arange(h) / s).astype(np.int64), H - 1)
        cols = np.minimum((np.arange(w) / s).astype(np.int64), W - 1)
        g = np.clip(frame[rows][:, cols], 0, 255).astype(np.uint8)
        self.img[oy:oy + h, ox:ox + w] = g[..., None]
        self.box = (ox, oy, ox + w - 1, oy + h - 1)
        self.xlim, self.ylim = (0.0, (w - 1) / s), ((h - 1) / s, 0.0)  # rows grow downwards

    def frame_and_grid(self) -> None:
        x0, y0, x1, y1 = self.box
        for lim, horizontal in ((self.xlim, False), (self.ylim, True)):
            lo, hi = min(lim), max(lim)
            step = _nice_step(hi - lo)
            for val in np.arange(np.ceil(lo / step) * step, hi, step):
                if horizontal:
                    r = int(np.clip(np.rint(self.px(self.xlim[0], val)[1]), y0, y1))
                    self.img[r, x0:x1 + 1] = GRID
                else:
                    c = int(np.clip(np.rint(self.px(val, self.ylim[0])[0]), x0, x1))
                    self.img[y0:y1 + 1, c] = GRID
        self.img[[y0, y1], x0:x1 + 1] = FRAME
        self.img[y0:y1 + 1, [x0, x1]] = FRAME


def render_run(t, p, gt_p=None, stats=None, frame=None, frame_pts=None, frame_valid=None):
    """The summary figure as an (H, 1210, 3) uint8 array and its panels
    {name: Axes} ("top-down", "altitude", "error", "overlay", "health",
    "events"), for ``plot_run``'s arguments."""
    t, p = np.asarray(t, np.float64), np.asarray(p, np.float64)
    gt = None if gt_p is None else np.asarray(gt_p, np.float64)
    n_rows = 2 + (1 if stats else 0)
    img = np.full((ROW_H * n_rows, FIG_W, 3), 255, np.uint8)
    half = FIG_W // 2

    def box(r, c):
        return (c * half, r * ROW_H, (c + 1) * half - 1, (r + 1) * ROW_H - 1)

    axes = {}
    xy = p[:, :2] if gt is None else np.concatenate([p[:, :2], gt[:, :2]])
    ax = axes["top-down"] = Axes(img, box(0, 0), xy[:, 0], xy[:, 1], equal=True)
    ax.frame_and_grid()
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], C_GT, dash=(6, 4))
    ax.plot(p[:, 0], p[:, 1], C_EST, width=2)
    if len(p):
        ax.markers(p[:1, 0], p[:1, 1], C_START, radius=4)

    z = p[:, 2] if gt is None else np.concatenate([p[:, 2], gt[:, 2]])
    ax = axes["altitude"] = Axes(img, box(0, 1), t, z)
    ax.frame_and_grid()
    if gt is not None:
        ax.plot(t, gt[:, 2], C_GT, dash=(6, 4))
    ax.plot(t, p[:, 2], C_EST, width=2)

    err = np.linalg.norm(p - gt, axis=1) if gt is not None else np.linalg.norm(p, axis=1)
    ax = axes["error"] = Axes(img, box(1, 0), t, err)
    ax.frame_and_grid()
    ax.plot(t, err, C_ERR if gt is not None else C_EST)

    if frame is not None:
        ax = axes["overlay"] = Axes(img, box(1, 1), [0, 1], [0, 1])
        ax.image(np.asarray(frame, np.float64))
        if frame_pts is not None:
            pts = np.asarray(frame_pts, np.float64)
            v = np.ones(len(pts), bool) if frame_valid is None else np.asarray(frame_valid, bool)
            ax.markers(pts[v, 0], pts[v, 1], C_FEAT, radius=3, filled=False)

    if stats:
        vals = [np.asarray(stats[k], np.float64) for k, _ in C_HEALTH if k in stats]
        ax = axes["health"] = Axes(img, box(2, 0), t, np.concatenate(vals) if vals else [0.0])
        ax.frame_and_grid()
        for key, colour in C_HEALTH:
            if key in stats:
                ax.plot(t, np.asarray(stats[key], np.float64), colour)
        ax = axes["events"] = Axes(img, box(2, 1), t, [0.0], ylim=(-0.1, 1.1))
        ax.frame_and_grid()
        for key, colour in C_EVENTS:
            if key in stats:
                ax.plot(t, np.asarray(stats[key], np.float64), colour)
    return img, axes


def plot_run(
    out_path: str,
    t: np.ndarray,  # (T,)
    p: np.ndarray,  # (T, 3) estimated positions
    gt_p: np.ndarray | None = None,  # (T, 3) ground truth (optional)
    stats: dict | None = None,  # per-frame health arrays (tracks, clones, ...)
    frame: np.ndarray | None = None,  # (H, W) sample grayscale frame
    frame_pts: np.ndarray | None = None,  # (F, 2) tracked px positions on it
    frame_valid: np.ndarray | None = None,  # (F,)
    title: str = "larvio_tpu_torch run",
) -> str:
    """Render the run summary PNG. Returns ``out_path``."""
    img, _ = render_run(t, p, gt_p, stats, frame, frame_pts, frame_valid)
    write_png_rgb(out_path, img, text={"Title": title})
    return out_path

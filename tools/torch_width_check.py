"""Which operations of a fleet step round a lane by the fleet's width or by
the lane's place in it (ROADMAP F4, F5).

    python3 tools/torch_width_check.py [--width 256] [--frame 60] [--k 8] [--features] [--device cuda]

A fleet of ``--width`` lanes runs ``--frame`` eager steps (image level: the
default configuration's clean 8 s workload rendered on the card, lane 0's
frames as they are, lane b with 2 gray levels of noise of its own seed;
``--features``: feature level, lane b the simulation of seed b), then one
more step under a ``TorchDispatchMode`` (``WidthCheck``). Every aten
operation that is given a tensor whose leading dimension is a multiple of
the width (the lanes, alone or folded with other axes, lane-major) is run
again twice on copies of its operands: on the first ``--k`` lanes (the
width changes, the lanes keep their places) and on all lanes permuted (the
width stays, every lane moves). Each such tensor is cut or permuted in
blocks of its own leading dimension / width; in-place operations run on
clones. A result whose leading dimension is a multiple of the width is held
to the same cut or permutation of the step's result, a result of at most a
lane's share of the operand's elements to the step's result as it is (a
reduction across the lanes), bit for bit; a reshape that moves the lanes
off the leading axis (a scan's time-major fold) is not compared.
A lane's bits are its own if no operation differs.

The tool prints one line per operation that differs (its site, the file and
line in the repository that called it; max |d| over the finite elements;
whether it depends on the width, the place or both), a summary and, last,
a JSON line. Operations whose re-run raises (a size argument that names the
width) are counted as not checked, and so are the cut re-runs of indexing
operations whose index along the leading axis points past the cut operand;
the permutation skips operations given an integer tensor of the width (an
index whose values may name lanes). Views, empty allocations and random
draws are not re-run. The kernels bound through ``ctypes`` (``lane_mm``,
K3, the detection kernel, describe) are not aten operations: their own
tests hold their lanes.
Exits 1 if an operation differs. Needs a CUDA GPU unless ``--device cpu`` is
asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from larvio_tpu_torch.config import VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.core.tree import tree_map  # noqa: E402

_TOOLS = os.path.join(REPO, "tools") + os.sep
_NOT_RERUN = ("aten::empty", "aten::new_empty", "aten::empty_like", "aten::empty_strided",
              "aten::new_empty_strided", "aten::resize_", "aten::set_", "aten::_local_scalar_dense")


@dataclass
class Finding:
    op: str
    site: str
    count: int = 0
    max_abs: float = 0.0
    width: bool = False
    place: bool = False

    def line(self) -> str:
        dep = " and ".join(x for x, on in (("the width", self.width), ("the place", self.place)) if on)
        return f"{self.site}: {self.op} differs ({self.count}x), max |d| {self.max_abs:.3e}, depends on {dep}"


def _site(depth: int = 1) -> str:
    """The deepest caller inside the repository outside ``tools/`` (the
    port's code, or a test's), as path:line relative to the repository;
    ``depth`` > 1 adds its callers there, joined by " < "."""
    sites, f = [], sys._getframe(1)
    while f is not None and len(sites) < depth:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(REPO + os.sep) and not path.startswith(_TOOLS):
            sites.append(f"{os.path.relpath(path, REPO)}:{f.f_lineno}")
        f = f.f_back
    return " < ".join(sites) or "?"


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous().reshape(-1)
    return t if t.dtype == torch.bool else t.view(torch.uint8)


class WidthCheck(TorchDispatchMode):
    """The dispatch mode that re-runs lane-aligned aten operations (see the
    module docstring). ``findings`` maps (op, site) to a ``Finding``."""

    def __init__(self, width: int, k: int = 8, seed: int = 0):
        super().__init__()
        if not 1 <= k < width:
            raise ValueError(f"k = {k} must be in [1, width = {width})")
        self.B, self.k = width, k
        self.perm = torch.randperm(width, generator=torch.Generator().manual_seed(seed))
        self.findings: dict = {}
        self.ops = self.aligned = self.not_checked = 0

    def _is_lanes(self, x) -> bool:
        return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] >= self.B and x.shape[0] % self.B == 0

    def _cut(self, t: torch.Tensor, mode: str) -> torch.Tensor:
        m = t.shape[0] // self.B
        if mode == "width":
            return t[:self.k * m].clone()
        return t.reshape(self.B, m, *t.shape[1:])[self.perm.to(t.device)].reshape(t.shape)

    @staticmethod
    def _indices_fit(func, va, vk) -> bool:
        """Whether an indexing operation's index along the leading axis stays
        inside the cut operand (on the card an index out of range is a
        device-side assert, which ends the process; indices along other axes
        and operations that index nothing are left alone)."""
        bound = dict(zip((a.name for a in func._schema.arguments), va))
        bound.update(vk)
        src = bound.get("self", bound.get("input"))
        if not isinstance(src, torch.Tensor) or src.dim() == 0:
            return True
        if isinstance(bound.get("indices"), (list, tuple)):
            idx, n = bound["indices"][0] if bound["indices"] else None, src.shape[0]
        elif isinstance(bound.get("index"), torch.Tensor):
            dim = bound.get("dim")
            if dim is None:  # take: a flat index
                idx, n = bound["index"], src.numel()
            else:
                idx, n = (bound["index"], src.shape[0]) if dim % src.dim() == 0 else (None, 0)
        else:
            return True
        if not isinstance(idx, torch.Tensor) or not idx.numel() or idx.dtype == torch.bool:
            return True
        return -n <= int(idx.min()) and int(idx.max()) < n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = func._schema.name
        if func.is_view or name in _NOT_RERUN or torch.Tag.nondeterministic_seeded in func.tags:
            return func(*args, **kwargs)
        flat, spec = tree_flatten((args, kwargs))
        lanes = [i for i, x in enumerate(flat) if self._is_lanes(x)]
        if not lanes:
            return func(*args, **kwargs)
        self.aligned += 1
        mutable = func._schema.is_mutable
        modes = ["width"]
        if all(flat[i].is_floating_point() or flat[i].dtype == torch.bool for i in lanes):
            modes.append("place")
        variants = {}
        for mode in modes:  # before the step's own run, which may write its operands
            v = list(flat)
            for i, x in enumerate(flat):
                if i in lanes:
                    v[i] = self._cut(x, mode)
                elif mutable and isinstance(x, torch.Tensor):
                    v[i] = x.clone()
            if mode == "width" and not self._indices_fit(func, *tree_unflatten(v, spec)):
                self.not_checked += 1
                continue
            variants[mode] = v
        out = func(*args, **kwargs)
        most = max(flat[i].numel() for i in lanes)
        site = None
        for mode, v in variants.items():
            try:
                va, vk = tree_unflatten(v, spec)
                again = func(*va, **vk)
            except Exception:  # noqa: BLE001 - a size argument names the width
                self.not_checked += 1
                continue
            for o, g in zip(tree_flatten(out)[0], tree_flatten(again)[0]):
                if not isinstance(o, torch.Tensor) or not isinstance(g, torch.Tensor):
                    continue
                if self._is_lanes(o):
                    want = self._cut(o, mode)
                elif o.numel() * self.B <= most:  # a reduction across the lanes: held as it is
                    want = o
                else:  # a reshape that moved the lanes off the leading axis: nothing to compare
                    continue
                if want.shape != g.shape or want.dtype != g.dtype or torch.equal(_bits(want), _bits(g)):
                    continue
                site = site or _site()
                f = self.findings.setdefault((name, site), Finding(name, site))
                f.count += 1
                setattr(f, mode, True)
                if want.is_floating_point():
                    ok = torch.isfinite(want) & torch.isfinite(g)
                    d = (want.double() - g.double()).abs()[ok]
                    f.max_abs = max(f.max_abs, float(d.max()) if d.numel() else 0.0)
        return out


def check_step(step, args, width: int, k: int = 8, seed: int = 0) -> WidthCheck:
    """Run ``step(*args)`` once under a ``WidthCheck``; returns the mode
    (its ``findings`` and counts)."""
    mode = WidthCheck(width, k, seed)
    with mode:
        step(*args)
    return mode


def _feature_run(cfg, width: int, frame: int, dev):
    """(fleet_step, its arguments at ``frame``): lane b the feature-level
    simulation of seed b, ``frame`` eager steps taken first."""
    from larvio_tpu_torch.api import make_frame_inputs
    from larvio_tpu_torch.data.sim import SimConfig, Simulator
    from larvio_tpu_torch.parallel.fleet import fleet_step, init_fleet_state

    duration = (frame + 2) / 20.0
    data = [Simulator(SimConfig(duration=duration, pixel_noise=0.002, seed=b), cfg).generate() for b in range(width)]
    feats, imu = make_frame_inputs({key: np.stack([d[key] for d in data], axis=1) for key in data[0]}, device=dev)
    state = init_fleet_state(cfg, width, dev)
    for t in range(frame):
        state, _ = fleet_step(cfg, state, *tree_map(lambda a: a[t], (feats, imu)))
    return (lambda *a: fleet_step(cfg, *a)), (state, *tree_map(lambda a: a[frame], (feats, imu)))


def _image_run(cfg, width: int, frame: int, dev):
    """(pipeline_step, its arguments at ``frame``): the clean 8 s workload
    rendered once, lane 0's frames as they are, lane b >= 1 with 2 gray
    levels of noise (a generator seeded by the frame), ``frame`` eager steps
    taken first."""
    from larvio_tpu_torch.data.render import render_sequence
    from larvio_tpu_torch.data.sim import SimConfig, Simulator
    from larvio_tpu_torch.models.propagation import ImuBatch
    from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state
    from larvio_tpu_torch.pipeline import FrameInput, pipeline_step

    sim = Simulator(SimConfig(duration=8.0), cfg)
    data = sim.generate()
    imgs = render_sequence(cfg, sim, data["t_img"][:frame + 1], device=dev)

    def inputs(t):
        img = imgs[t][None].expand(width, *imgs.shape[1:]).clone()
        gen = torch.Generator(device=dev).manual_seed(1000 + t)
        img[1:] += 2.0 * torch.randn(img[1:].shape, generator=gen, device=dev)
        lane = lambda key: torch.as_tensor(data[key][t], device=dev).expand(width, *np.shape(data[key][t]))  # noqa: E731
        return FrameInput(image=img, t=lane("t_img").contiguous(),
                          imu=ImuBatch(t=lane("imu_t").contiguous(), w=lane("imu_w").contiguous(),
                                       a=lane("imu_a").contiguous(), valid=lane("imu_valid").contiguous()))

    state = init_fleet_pipeline_state(cfg, width, dev)
    for t in range(frame):
        state, _ = pipeline_step(cfg, state, inputs(t))
    return (lambda *a: pipeline_step(cfg, *a)), (state, inputs(frame))


def run(width: int = 256, frame: int = 60, k: int = 8, features: bool = False, device="cuda",
        cfg: VioConfig | None = None) -> dict:
    """The check; returns the JSON summary (``findings``: every operation that
    differs)."""
    dev = resolve_device(device)
    card_numerics()
    cfg = cfg or VioConfig()
    step, args = (_feature_run if features else _image_run)(cfg, width, frame, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mode = check_step(step, args, width, k)
    found = sorted(mode.findings.values(), key=lambda f: f.site)
    for f in found:
        print(f.line(), flush=True)
    print(f"width {width}, frame {frame}, {'feature' if features else 'image'} level, k = {k}: {mode.ops} aten "
          f"operations, {mode.aligned} given the lanes and re-run ({mode.not_checked} re-runs raised); "
          f"{len(found)} differ{'' if found else ': every lane bit for bit its own'}", flush=True)
    return {"width": width, "frame": frame, "k": k, "level": "feature" if features else "image",
            "ops": mode.ops, "rerun": mode.aligned, "not_checked": mode.not_checked,
            "findings": [vars(f) for f in found], "device": str(dev) if dev.type != "cuda"
            else torch.cuda.get_device_name(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Which aten operations of a fleet step depend on the fleet's width.")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frame", type=int, default=60, help="eager steps before the checked one")
    ap.add_argument("--k", type=int, default=8, help="lanes of the cut re-run")
    ap.add_argument("--features", action="store_true", help="feature level (fleet_step) in place of images")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.width, args.frame, args.k, args.features, args.device)
    print(json.dumps(res), flush=True)
    return 1 if res["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())

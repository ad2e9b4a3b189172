"""Whether the port gives the same bits in two processes (ROADMAP F6).

    python3 tools/torch_repro_check.py [--fleet B] [--frames N] [--frame k] [--size WxH] [--device cuda]

The cross-process counterpart of ``tools/torch_width_check.py``. Two fresh
child processes (a new interpreter each) run one workload: the default
configuration's clean 8 s image-level workload, ``--frames`` frames of it
(default 160) rendered by ``data/render.py::Renderer``, stepped eagerly by
``pipeline_step`` (``--fleet B``: B lanes through the batched step, built as
``chip_smoke.py`` phase 4 builds them: lane 0 the rendered frames, lane b
with 2 gray levels of noise of seed b, the last lane with NaN accelerometer
samples over frames 80-99). The second child gets another history before
the workload starts: it holds an allocation of an odd size, renders and
discards one frame and warms cuBLAS on an unrelated product.

Each child writes digests (``hashlib.sha256`` of dtype, shape and bytes):
every rendered frame; per frame, the step's input, outputs and state, leaf
by leaf; and, for frame ``--frame`` (default 60), a recorded block run under
a ``TorchDispatchMode`` (``Recorder``): frame k rendered once more, then the
eager step. The block's record holds every aten operation in call order
(views and empty allocations aside) with its site (the deepest caller's
file and line in the repository outside ``tools/``, as
``torch_width_check.py`` names it), the
digests of its tensor inputs and of its outputs, and the outputs of the
kernels bound through ``ctypes`` (K1 / K3, the detection kernel, describe,
``lane_mm``, ``lane_trsm``) taken at their wrappers. Each child also
renders the whole sequence twice and compares the two renders bit for bit.

The parent prints the first rendered frame that differs, the first frame
whose input and whose outputs or state differ (with the leaves), the first
operation of the recorded block that differs (its site and max |d|), the
sources among them (operations whose inputs are equal in both records and
whose outputs are not), the kernel calls that differ, a summary and, last,
a JSON line. Exits 1 if anything differs. Needs a CUDA GPU unless ``--device
cpu`` is asked for (a small ``--size`` keeps a CPU run short).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from larvio_tpu_torch.config import CameraConfig, VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.core.tree import leaves, tree_map  # noqa: E402
from larvio_tpu_torch.data.render import Renderer, render_frames  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.models.propagation import ImuBatch  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state  # noqa: E402
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step  # noqa: E402
from tools.torch_width_check import _site  # noqa: E402

# operations whose outputs are uninitialized memory (views and the profiler's
# region markers, which are no aten operations, are not recorded either)
_NOT_RECORDED = ("aten::empty", "aten::new_empty", "aten::empty_like", "aten::empty_strided",
                 "aten::new_empty_strided", "aten::resize_", "aten::set_")
KEEP_BYTES = 1 << 24  # outputs kept as values (for max |d|) up to this size each


def digest(x) -> str:
    """SHA-256 of a tree's leaves (``core/tree.py::leaves``: each tensor's
    dtype, shape and bytes, any other leaf's repr), 24 hex digits."""
    h = hashlib.sha256()
    for leaf in leaves(x):
        if isinstance(leaf, torch.Tensor):
            h.update(f"{leaf.dtype}{tuple(leaf.shape)}".encode())
            h.update(leaf.detach().cpu().numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()[:24]


def named_leaves(tree, prefix: str = ""):
    """(path, leaf) of a tree of dataclasses / tuples / lists / dicts."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from named_leaves(getattr(tree, f.name), f"{prefix}.{f.name}" if prefix else f.name)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def frame_digests(imgs: torch.Tensor) -> list:
    """One digest per frame of a (T, ...) stack."""
    return [digest(x) for x in imgs]


def _tensors(args, kwargs):
    """The tensors among an operation's arguments (lists of tensors included)."""
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


class Recorder(TorchDispatchMode):
    """Records every aten operation run under it (see the module docstring):
    ``ops`` is a list of {"op", "site", "in", "out"} (digests), ``values``
    maps "op{i}.{j}" to output j of operation i as a numpy array (floating
    outputs of at most ``KEEP_BYTES``)."""

    def __init__(self, values: dict):
        super().__init__()
        self.ops, self.values = [], values

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if not name.startswith("aten::") or func.is_view or name in _NOT_RECORDED:
            return func(*args, **kwargs)
        # inputs before the call: an in-place operation writes its operand
        ins = [digest(x) for x in _tensors(args, kwargs)]
        out = func(*args, **kwargs)
        outs = list(leaves(out))
        i = len(self.ops)
        self.ops.append({"op": name, "site": _site(), "in": ins, "out": [digest(o) for o in outs]})
        keep(self.values, f"op{i}", outs)
        return out


def keep(values: dict, key: str, outs) -> None:
    """Floating outputs of at most ``KEEP_BYTES`` into ``values`` as "{key}.{j}"."""
    for j, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and o.is_floating_point() and o.numel() * o.element_size() <= KEEP_BYTES:
            values[f"{key}.{j}"] = o.detach().cpu().numpy()


class KernelTaps:
    """Inside ``with``: the wrappers of the ``ctypes`` kernels, as the step
    calls them (``models/frontend.py``: ``build_pyramid``, ``grad_pyramid``,
    ``lk_track_cuda``, ``detect_corners``, ``describe``; ``core/linalg.py``:
    ``lane_mm``, ``lane_solve_triangular``),
    replaced by taps that call them and record their outputs (``calls``:
    {"kernel", "site", "out"}; ``values`` "k{i}.{j}")."""

    def __init__(self, values: dict):
        from larvio_tpu_torch.core import linalg
        from larvio_tpu_torch.models import frontend

        self.calls, self.values = [], values
        self._slots = [(frontend, "build_pyramid"), (frontend, "grad_pyramid"), (frontend, "lk_track_cuda"),
                       (frontend, "detect_corners"), (frontend, "describe"),
                       (linalg, "lane_mm"), (linalg, "lane_solve_triangular")]
        self._saved = []

    def _tap(self, name, fn):
        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = list(leaves(out))
            i = len(self.calls)
            self.calls.append({"kernel": name, "site": _site(2), "out": [digest(o) for o in outs]})
            keep(self.values, f"k{i}", outs)
            return out
        return tapped

    def __enter__(self):
        for mod, name in self._slots:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._tap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()


def workload_config(size: str | None) -> VioConfig:
    """The default configuration, at the camera size ``WxH`` if given (the
    EuRoC intrinsics scaled by W / 752)."""
    cfg = VioConfig()
    if not size:
        return cfg
    w, h = (int(v) for v in size.lower().split("x"))
    s = w / cfg.camera.width
    return VioConfig(camera=CameraConfig(width=w, height=h, intrinsics=tuple(v * s for v in cfg.camera.intrinsics)))


NAN_LANE_FRAMES = (80, 100)  # the last lane's NaN accelerometer frames (chip_smoke.py phase 4)


def fleet_frames(data: dict, imgs: torch.Tensor, B: int, copies=()) -> FrameInput:
    """(T, B, ...) frames of a fleet (``chip_smoke.py`` phase 4): lane 0 and
    the lanes ``copies`` see ``imgs``, lane b the frames plus 2 gray levels of
    noise from ``torch.Generator(device).manual_seed(b)``; the last lane's
    accelerometer samples are NaN over ``NAN_LANE_FRAMES``."""
    T, dev = imgs.shape[0], imgs.device
    bimgs = torch.empty((T, B, *imgs.shape[1:]), dtype=torch.float32, device=dev)
    for b in range(B):
        if b == 0 or b in copies:
            bimgs[:, b] = imgs
            continue
        gen = torch.Generator(device=dev).manual_seed(b)
        bimgs[:, b] = imgs + 2.0 * torch.randn(imgs.shape, generator=gen, device=dev)
    a = np.repeat(data["imu_a"][:T, None], B, axis=1)
    a[slice(*NAN_LANE_FRAMES), B - 1] = np.nan

    def lanes(x):
        x = np.asarray(x)[:T]
        return torch.as_tensor(np.ascontiguousarray(np.broadcast_to(x[:, None], (T, B, *x.shape[1:]))), device=dev)

    return FrameInput(image=bimgs, imu=ImuBatch(t=lanes(data["imu_t"]), w=lanes(data["imu_w"]),
                                                a=torch.as_tensor(a, device=dev), valid=lanes(data["imu_valid"])),
                      t=lanes(data["t_img"]))


def single_frames(data: dict, imgs: torch.Tensor) -> FrameInput:
    """(T, ...) frames of the single path over ``imgs``."""
    T, dev = imgs.shape[0], imgs.device
    g = {k: torch.as_tensor(data[k][:T], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    return FrameInput(image=imgs, imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]),
                      t=g["t_img"])


def other_history(dev, sim, rend) -> list:
    """What the second child does before its workload: an allocation of an
    odd size (kept alive), one frame rendered and dropped, cuBLAS warmed on
    an unrelated product. Returns what it keeps."""
    held = torch.empty(12_345_679, dtype=torch.uint8, device=dev)
    render_frames(rend, sim, [3.3])
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn((7, 97, 131), generator=gen, device=dev)
    (a @ a.transpose(-1, -2)).sum().item()
    return [held]


def child(args) -> None:
    """One child: the workload, written to ``args.child`` + ".json" (digests)
    and ".npz" (the rendered frames, the recorded block's values)."""
    dev = resolve_device(args.device)
    card_numerics()
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the CPU children's sums in one order, whatever the host's cores
    cfg = workload_config(args.size)
    sim = Simulator(SimConfig(duration=8.0), cfg)
    data = sim.generate()
    T = min(args.frames, len(data["t_img"]))
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    held = other_history(dev, sim, rend) if args.history else []
    t0 = time.perf_counter()
    imgs = render_frames(rend, sim, data["t_img"][:T])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    render_s = time.perf_counter() - t0
    again = render_frames(rend, sim, data["t_img"][:T])
    rerender = [i for i in range(T) if not torch.equal(imgs[i].view(torch.int32), again[i].view(torch.int32))]
    rerender = {"differ": len(rerender), "first": rerender[0] if rerender else None,
                "max_abs": float((imgs - again).abs().max()) if rerender else 0.0}
    del again
    frames = fleet_frames(data, imgs, args.fleet) if args.fleet else single_frames(data, imgs)
    ps = init_fleet_pipeline_state(cfg, args.fleet, dev) if args.fleet else init_pipeline_state(cfg, dev)
    values = {"frames": imgs.cpu().numpy()}
    steps, rec, taps = [], Recorder(values), KernelTaps(values)
    for t in range(T):
        x = tree_map(lambda a: a[t], frames)
        if t == args.frame:
            with taps, rec:
                render_frames(rend, sim, data["t_img"][t:t + 1])
                ps, out = pipeline_step(cfg, ps, x)
        else:
            ps, out = pipeline_step(cfg, ps, x)
        steps.append({"input": digest(x), "out": {k: digest(v) for k, v in named_leaves(out)},
                      "state": {k: digest(v) for k, v in named_leaves(ps)}})
    record = {"frames": frame_digests(imgs), "rerender": rerender,
              "render_s": render_s, "steps": steps, "frame": args.frame if args.frame < T else None,
              "ops": rec.ops, "kernels": taps.calls, "history": args.history,
              "fleet": args.fleet, "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev)}
    del held
    with open(args.child + ".json", "w") as f:
        json.dump(record, f)
    np.savez(args.child + ".npz", **values)


def _max_abs(va, vb, key: str):
    """max |d| over the finite elements of ``key`` in both value files, or
    None where either did not keep it."""
    if va is None or vb is None or key not in va.files or key not in vb.files:
        return None
    a, b = va[key].astype(np.float64), vb[key].astype(np.float64)
    if a.shape != b.shape:
        return None
    ok = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def _first(a: list, b: list):
    """The first index where two lists differ (a length difference counts), or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def compare(a: dict, b: dict, va=None, vb=None) -> dict:
    """What differs between two child records (``va``, ``vb``: their value
    files, for max |d|). Returns {"rendered", "input", "step", "op",
    "sources", "kernels", "rerender", "differs"}."""
    res = {}
    i = _first(a["frames"], b["frames"])
    res["rendered"] = None if i is None else {
        "index": i, "count": sum(x != y for x, y in zip(a["frames"], b["frames"])),
        "max_abs": (None if va is None or vb is None else
                    float(np.abs(va["frames"][i].astype(np.float64) - vb["frames"][i]).max()))}
    i = _first([s["input"] for s in a["steps"]], [s["input"] for s in b["steps"]])
    res["input"] = i
    res["step"] = None
    for t, (sa, sb) in enumerate(zip(a["steps"], b["steps"])):
        diff = [k for part in ("out", "state") for k in sa[part] if sa[part][k] != sb[part].get(k)]
        if diff:
            res["step"] = {"index": t, "leaves": diff}
            break
    res["op"], res["sources"] = None, {}
    ops_a, ops_b = a["ops"], b["ops"]
    for i, (x, y) in enumerate(zip(ops_a, ops_b)):
        if (x["op"], x["site"]) != (y["op"], y["site"]):
            res["op"] = res["op"] or {"index": i, "op": x["op"], "site": x["site"], "max_abs": None,
                                      "diverges": f"{y['op']} at {y['site']}"}
            break
        if x["out"] == y["out"]:
            continue
        d = max((m for j in range(len(x["out"])) if (m := _max_abs(va, vb, f"op{i}.{j}")) is not None),
                default=None)
        res["op"] = res["op"] or {"index": i, "op": x["op"], "site": x["site"], "max_abs": d}
        if x["in"] == y["in"]:  # a source: equal inputs, other outputs
            s = res["sources"].setdefault(f"{x['op']} at {x['site']}", {"count": 0, "max_abs": None})
            s["count"] += 1
            if d is not None:
                s["max_abs"] = max(s["max_abs"] or 0.0, d)
    if res["op"] is None and len(ops_a) != len(ops_b):
        res["op"] = {"index": min(len(ops_a), len(ops_b)), "op": "(end)", "site": "?", "max_abs": None,
                     "diverges": f"{len(ops_a)} against {len(ops_b)} operations"}
    res["kernels"] = [{"index": i, "kernel": x["kernel"], "site": x["site"],
                       "max_abs": max((m for j in range(len(x["out"]))
                                       if (m := _max_abs(va, vb, f"k{i}.{j}")) is not None), default=None)}
                      for i, (x, y) in enumerate(zip(a["kernels"], b["kernels"])) if x["out"] != y["out"]]
    if len(a["kernels"]) != len(b["kernels"]):
        res["kernels"].append({"index": None, "kernel": f"{len(a['kernels'])} against {len(b['kernels'])} calls"})
    res["rerender"] = {"first child": a["rerender"], "second child": b["rerender"]}
    res["differs"] = bool(res["rendered"] or res["input"] is not None or res["step"] or res["op"] or res["kernels"]
                          or a["rerender"]["differ"] or b["rerender"]["differ"])
    return res


def _fmt(d) -> str:
    return "not kept" if d is None else f"{d:.3e}"


def report(res: dict, a: dict, b: dict) -> None:
    """The lines the parent prints for ``compare``'s result."""
    T, k = len(a["frames"]), a["frame"]
    f = res["rendered"]
    print("rendered frames: " + (f"all {T} equal" if f is None else
          f"frame {f['index']} is the first that differs ({f['count']} of {T} differ), max |d| {_fmt(f['max_abs'])}"),
          flush=True)
    for who, r in res["rerender"].items():
        print(f"rendered twice in the {who}: " + ("equal" if not r["differ"] else
              f"{r['differ']} frames differ (first {r['first']}), max |d| {r['max_abs']:.3e}"), flush=True)
    print("step inputs: " + ("equal at every frame" if res["input"] is None else
          f"frame {res['input']} is the first whose input differs"), flush=True)
    s = res["step"]
    print("step outputs and state: " + ("equal at every frame" if s is None else
          f"frame {s['index']} is the first that differs, in {', '.join(s['leaves'][:8])}"
          + (f" and {len(s['leaves']) - 8} more leaves" if len(s["leaves"]) > 8 else "")), flush=True)
    o = res["op"]
    print(f"recorded block (frame {k} rendered again, then its step; {len(a['ops'])} aten operations, "
          f"{len(a['kernels'])} kernel calls): " + ("every operation equal" if o is None else
          f"operation #{o['index']} {o['op']} at {o['site']} is the first that differs, max |d| "
          f"{_fmt(o['max_abs'])}" + (f" (the other record has {o['diverges']})" if "diverges" in o else "")),
          flush=True)
    for site, v in res["sources"].items():
        print(f"  source (inputs equal, outputs differ): {site}, {v['count']}x, max |d| {_fmt(v['max_abs'])}",
              flush=True)
    for kc in res["kernels"][:10]:
        print(f"  kernel call #{kc['index']} {kc['kernel']} at {kc.get('site', '?')} differs, max |d| "
              f"{_fmt(kc.get('max_abs'))}", flush=True)


def run(args) -> dict:
    """The two children, then the comparison; returns the JSON summary."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], [os.path.join(tmp, f"child{i}") for i in range(2)]
        for i, out in enumerate(outs):  # both at once: neither sees the other's history
            cmd = [sys.executable, os.path.abspath(__file__), "--child", out, "--frames", str(args.frames),
                   "--frame", str(args.frame), "--fleet", str(args.fleet), "--device", args.device]
            cmd += ["--size", args.size] if args.size else []
            cmd += ["--history"] if i else []
            procs.append(subprocess.Popen(cmd, cwd=REPO))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"a child failed (exit codes {codes})")
        recs = []
        for out in outs:
            with open(out + ".json") as f:
                recs.append(json.load(f))
        with np.load(os.path.join(tmp, "child0.npz")) as va, np.load(os.path.join(tmp, "child1.npz")) as vb:
            res = compare(*recs, va, vb)
    a, b = recs
    report(res, a, b)
    what = f"fleet of {args.fleet} lanes" if args.fleet else "single instance"
    print(f"{what}, {len(a['frames'])} frames{f' at {args.size}' if args.size else ''}, frame {a['frame']} "
          f"recorded: " + ("the two processes differ" if res["differs"] else
                           "the two processes agree bit for bit (frames, inputs, outputs, state, every operation "
                           "and kernel call of the recorded block; each render repeated in its process)")
          + f"; render {a['render_s']:.3f} / {b['render_s']:.3f} s; {time.perf_counter() - t0:.1f} s on "
          f"{a['device']}", flush=True)
    return {"fleet": args.fleet, "frames": len(a["frames"]), "frame": a["frame"], "ops": len(a["ops"]),
            "kernel_calls": len(a["kernels"]), "render_s": [a["render_s"], b["render_s"]], "device": a["device"],
            **{k: v for k, v in res.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Whether two processes give the port's image-level run the same bits.")
    ap.add_argument("--fleet", type=int, default=0, help="B lanes through the batched step (0: one instance)")
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--frame", type=int, default=60, help="the frame whose render and step are recorded")
    ap.add_argument("--size", default=None, help="camera WxH (default: the configuration's 752x480)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--history", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    if resolve_device(args.device).type == "cuda":
        from tools.torch_bench import card_line

        print(card_line(), flush=True)  # name, power limit (nvidia-smi)
    res = run(args)
    print(json.dumps(res), flush=True)
    return 1 if res["differs"] else 0


if __name__ == "__main__":
    sys.exit(main())

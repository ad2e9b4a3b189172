"""The comparison that decides ``correct``: what the timed path produced, at
the cell's own sizes, against the plain reference (``vio_bench/reference``),
frame by frame and stage by stage, on frames the run drew from its seed.

The reference follows the program step by step from the program's own
state: a run of the reference over a whole flight would take many times
the window, and the front end's decisions (which slots keep their track,
where a new corner lands) flip on the last bit of a sum, so two whole runs
part ways within frames whatever their precision. So each checked frame is
judged in two stages, each from the program's own input to it:

* the front end: the reference's ``track_frame`` from the program's tracker
  state before the frame, on the same image and IMU batch, against the
  program's tracker state after it;
* the filter: the reference's ``filter_step`` from the program's filter
  state before the frame, given the features the program's front end
  handed on (read off its tracker states before and after: ids, positions,
  validity, velocities, mean motion), against the program's filter state
  after the frame and its outputs.

The start, which this skips, is checked by itself: the program's initial
state against the reference's (``start``).

Numbers, each the worst over the run's checked frames (one instance each,
a fleet's lanes drawn from the seed):

* ``start``: elements of the initial state that differ (bit for bit).
* ``fe_lost``: the share, in %, of the slots that could track (valid
  before the frame, with a previous frame) whose track ran through the
  frame on one side and not on the other. A track runs through where the
  slot is valid after the frame with the same id and an age above 0: it
  passed LK (K1, or K3 in a fleet), RANSAC and the descriptor gate.
* ``fe_off``: the share, in %, of the tracks that ran through the frame on
  both sides whose positions differ by more than ten times LK's stopping
  step (``track_precision``): LK's own output, K1's or K3's.
* ``fe_px``: the largest of those gaps, in pixels (printed, not held: a
  track that did not converge can land pixels apart on a sound run).
* ``fe_new``: new corners (valid with age 0) at a position that the other
  side did not detect, over the table's slots, in %: Shi-Tomasi, the grid's
  quotas and the slot assignment.
* ``discrete``: elements that differ among the filter state's integer and
  boolean leaves and the outputs' flags and counts.
* ``pose_m``, ``vel_mps``, ``att_rad``: the largest gap of the output
  position, velocity and attitude.
* ``cov``: the largest gap of the covariance (the square-root factor
  squared out, in float64) over the product of the reference's standard
  deviations of its row and column (the median one's thousandth at least).
* ``state``: the largest gap of any other floating-point leaf of the filter
  state, over the larger of that leaf's largest magnitude and the median
  leaf's.

* ``unchecked``: frames the check drew that never came to be checked (a
  fleet whose checked lanes never updated).

NaN against NaN is agreement; NaN against a number is an infinite gap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from vio_bench.reference import config as ref_config
from vio_bench.reference import step as ref_step
from vio_bench.reference.core.tree import tree_map
from vio_bench.reference.models import frontend as ref_frontend
from vio_bench.reference.models import msckf as ref_msckf
from vio_bench.reference.models.propagation import ImuBatch as RefImuBatch

NUMBERS = ("start", "fe_lost", "fe_off", "fe_px", "fe_new", "discrete", "pose_m", "vel_mps", "att_rad", "cov", "state",
           "unchecked")
OUTPUT_FLAGS = ("initialized", "stationary", "n_clones", "n_tracks", "n_updated", "n_slam", "did_reset")


def ref_cfg(vio: dict):
    from vio_bench.port import build_cfg  # build_cfg alone; the classes are the reference's

    return build_cfg(vio, (ref_config.VioConfig, ref_config.CameraConfig, ref_config.NoiseConfig,
                           ref_config.FrontendConfig, ref_config.FilterConfig))


@dataclasses.dataclass
class Frame:
    """One checked frame of one instance: the program's state before and
    after it, its outputs, and the frame's inputs (``image``, ``t``,
    ``imu_t``, ``imu_w``, ``imu_a``, ``imu_valid``)."""

    label: str
    before: object
    after: object
    outputs: dict
    inputs: dict


def _paths(tree, prefix=""):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _paths(getattr(tree, f.name), f"{prefix}{f.name}.")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def to_reference(ref_template, tree, device):
    """The program's ``tree`` (one instance) as the reference's classes (the
    same fields in the same order), every leaf copied to ``device``."""
    return tree_map(lambda _, x: x.to(device).clone(), ref_template, tree)


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise in float64, 0 where both are NaN, inf where one is."""
    a, b = a.double(), b.to(a.device).double()
    d = (a - b).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, 0.0, d)
    return torch.where(na ^ nb, math.inf, torch.nan_to_num(d, nan=math.inf))


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _differ(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.to(a.device)
    if a.dtype.is_floating_point:
        return float(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())
    return float((a != b).sum())


def compare_start(got, ref) -> dict:
    """Elements of two initial states that differ."""
    r = dict(_paths(ref))
    return {"start": sum(_differ(a, r[p]) for p, a in _paths(got))}


def _through(before, after) -> torch.Tensor:
    """Slots whose track ran through the frame: valid before and after it,
    with the same id and an age above 0."""
    return before.valid & after.valid & (after.ids == before.ids) & (after.age > 0)


def _corners(after) -> set:
    """Positions of the new corners (valid, age 0)."""
    return {tuple(xy) for xy in after.pos[after.valid & (after.age == 0)].tolist()}


def _off_px(cfg) -> float:
    return 10.0 * cfg.frontend.track_precision


def compare_tracker(before, got, ref, off_px: float) -> dict:
    """The front end's numbers: the program's tracker state after a frame
    (``got``) against the reference's, both from the program's tracker
    state ``before`` it; ``off_px``: the gap that counts a track as off."""
    dev = ref.ids.device
    before, got = (tree_map(lambda _, x: x.to(dev), ref, t) for t in (before, got))
    can = before.valid & before.has_prev
    tg, tr = _through(before, got), _through(before, ref)
    both = tg & tr
    px = _gap(got.pos, ref.pos).pow(2).sum(dim=-1).sqrt()
    return {"fe_lost": 100.0 * float(((tg != tr) & can).sum()) / max(float(can.sum()), 1.0),
            "fe_off": 100.0 * float((px[both] > off_px).sum()) / max(float(both.sum()), 1.0),
            "fe_px": _max(px[both]),
            "fe_new": 100.0 * len(_corners(got) ^ _corners(ref)) / ref.ids.shape[-1]}


def _cov(cfg, P: torch.Tensor) -> torch.Tensor:
    P = P.double()
    return P @ P.transpose(-1, -2) if cfg.filter.sqrt_form else P


def _att(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Angle between unit quaternions (..., 4), in float64."""
    qa, qb = qa.double(), qb.to(qa.device).double()
    d = torch.minimum((qa - qb).norm(dim=-1), (qa + qb).norm(dim=-1))
    return 4.0 * torch.asin(torch.clamp(d / 2.0, max=1.0))


def compare_filter(cfg, got, ref, got_out: dict, ref_out: dict) -> dict:
    """The filter's numbers: the program's filter state and outputs after a
    frame against the reference's."""
    out = {"discrete": 0.0, "cov": 0.0, "state": 0.0}
    r = dict(_paths(ref))
    floats = []
    for path, a in _paths(got):
        b = r[path]
        if not a.dtype.is_floating_point:
            out["discrete"] += _differ(a, b)
        elif path == "filter.P":
            Pg, Pr = _cov(cfg, a.to(b.device)), _cov(cfg, b)
            sd = torch.sqrt(torch.clamp(torch.diagonal(Pr), min=0.0))
            sd = torch.clamp(sd, min=1e-3 * float(sd.median()) + 1e-300)
            out["cov"] = _max(_gap(Pg, Pr) / (sd[:, None] * sd[None, :]))
        else:
            floats.append((_max(_gap(a, b)), _max(torch.nan_to_num(b.double().abs(), nan=0.0))))
    if floats:
        median = float(np.median([m for _, m in floats]))
        out["state"] = max(d / max(m, median, 1e-30) for d, m in floats)
    out["discrete"] += sum(_differ(torch.as_tensor(got_out[k]), torch.as_tensor(ref_out[k])) for k in OUTPUT_FLAGS)
    att = _att(got_out["q"], ref_out["q"])
    out.update(pose_m=_max(_gap(got_out["p"], ref_out["p"])), vel_mps=_max(_gap(got_out["v"], ref_out["v"])),
               att_rad=_max(torch.where(torch.isnan(att), math.inf, att)))
    return out


def merge(a: dict, b: dict) -> dict:
    """Worst of two readings, number by number."""
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


def handed_on(before, after, t: torch.Tensor):
    """The features a front end handed on to the filter, read off its
    tracker states before and after the frame (the reference's classes):
    a slot is new where it is valid with age 0, moved where it is valid and
    not new; velocities and the mean motion as ``track_frame`` forms them."""
    is_new = after.valid & (after.age == 0)
    moved = after.valid & ~is_new
    dt = torch.clamp(t - before.prev_time, min=1e-6)[..., None, None]
    vel = torch.where(moved[..., None], (after.uv_norm - before.uv_norm) / dt, 0.0)
    motion = torch.linalg.norm(after.uv_norm - before.uv_norm, dim=-1)
    n_moved = torch.sum(moved, dim=-1)
    mean_motion = torch.where(n_moved > 0, torch.sum(torch.where(moved, motion, 0.0), dim=-1)
                              / torch.clamp(n_moved, min=1), 1.0).to(after.uv_norm.dtype)
    return ref_msckf.FrameFeatures(ids=after.ids, uv=after.uv_norm, vel=vel, valid=after.valid,
                                   mean_motion=mean_motion, t=t)


def reference_frame(cfg, template, fr: Frame, device, control: bool = False) -> tuple:
    """The reference's two stages on one checked frame, each from the
    program's input to it: (tracker state after, filter state after,
    outputs as a dict). ``control``: in the precision below the
    configuration's: the front end in bfloat16 (``_Bf16Results``), the
    filter with TF32 products (``lower_precision``)."""
    before = to_reference(template, fr.before, device)
    after = to_reference(template, fr.after, device)
    f = {k: v.to(device) for k, v in fr.inputs.items()}
    imu = RefImuBatch(t=f["imu_t"], w=f["imu_w"], a=f["imu_a"], valid=f["imu_valid"])
    with torch.no_grad():
        image = f["image"].to(torch.float32).contiguous()
        with _Bf16Results() if control else contextlib.nullcontext():
            tracker, _ = ref_frontend.track_frame(cfg, before.tracker, image, imu, f["t"], before.vio.filter.bg)
        feats = handed_on(before.tracker, after.tracker, f["t"])
        with lower_precision(device) if control else contextlib.nullcontext():
            vio, out = ref_msckf.filter_step(cfg, before.vio, feats, imu)
    return tracker, vio, {fl.name: getattr(out, fl.name) for fl in dataclasses.fields(out)}


def check(cfg_dict: dict, initial, frames: list, device, unchecked: int = 0) -> dict:
    """The run's numbers: the program against the reference, the worst over
    its checked frames; ``initial``: the program's initial state (one
    instance); ``unchecked``: frames the check drew that never came."""
    cfg = ref_cfg(cfg_dict)
    template = ref_step.init_pipeline_state(cfg, device)
    nums = merge({k: 0.0 for k in NUMBERS}, compare_start(initial, template))
    nums["unchecked"] = float(unchecked)
    for fr in frames:
        tracker, vio, out = reference_frame(cfg, template, fr, device)
        nums = merge(nums, compare_tracker(fr.before.tracker, fr.after.tracker, tracker, _off_px(cfg)))
        nums = merge(nums, compare_filter(cfg, fr.after.vio, vio, fr.outputs, out))
    return nums


def check_control(cfg_dict: dict, frames: list, device) -> dict:
    """The control's numbers: the reference in the precision below the
    configuration's (its front end in bfloat16, its filter with TF32
    products), put in the program's place on the same frames (from the same
    states and features), against the reference."""
    cfg = ref_cfg(cfg_dict)
    template = ref_step.init_pipeline_state(cfg, device)
    nums = {k: 0.0 for k in NUMBERS}
    for fr in frames:
        tracker, vio, out = reference_frame(cfg, template, fr, device)
        c_tracker, c_vio, c_out = reference_frame(cfg, template, fr, device, control=True)
        nums = merge(nums, compare_tracker(fr.before.tracker, c_tracker, tracker, _off_px(cfg)))
        nums = merge(nums, compare_filter(cfg, c_vio, vio, c_out, out))
    return nums


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).reshape(x.shape)


class _Tf32Operands(torch.overrides.TorchFunctionMode):
    """Rounds the float32 operands of every product to TF32 (the CPU's
    stand-in for the card's TF32 products, which round their inputs so)."""

    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.Tensor.__matmul__, torch.Tensor.matmul}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            args = tuple(_round_tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **kwargs)


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32) if isinstance(x, torch.Tensor) and x.dtype == torch.float32 else x


class _Bf16Results(torch.overrides.TorchFunctionMode):
    """Every float32 result rounded to bfloat16 (the nearest below float32
    for what is not a product), kept in float32 for the operations after it:
    the front end computed in bfloat16."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if type(out) in (tuple, list):
            return type(out)(_round_bf16(x) for x in out)
        return _round_bf16(out)


@contextlib.contextmanager
def lower_precision(device):
    """The control's precision: the configuration states float32 with TF32
    off; the nearest below is TF32. On the card TF32 is switched on for
    every float32 product and convolution; on the CPU, which has no TF32,
    the products' operands are rounded to it."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        if torch.device(device).type == "cuda":
            yield
        else:
            with _Tf32Operands():
                yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, number, limit)]): every number within its limit."""
    rows = [(k, nums[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows

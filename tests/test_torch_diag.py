"""The port's diagnostics against the JAX package: ``track_frame(debug=True)``,
the stage regions and ``tools/torch_trace_analyze.py``, ``--debug-nans``,
the run-summary figure (``data/visualize.py``, the RGB PNG writer) and
``cli run --live``.

One configuration (240x320 camera, 48 feature slots, 8 clones, 3 SLAM
slots), built for both packages from one dict; frames rendered by the JAX
package from one simulator run. Tolerances:
- ``track_frame(debug=True)``, 20 frames, each from the JAX tracker's
  converted state, one instance and a 2-lane fleet: the five masks
  (``can_track``, ``lk_survived``, ``ransac_survived``, ``orb_survived``,
  ``is_new``) equal the JAX package's exactly; ``orb_dist`` equal on at
  least 99% of the slot-frames and within 2 bits on all: a descriptor bit
  of a rare slot flips with the order of the ORB moment sums (ROADMAP
  deviation 5; XLA's compiled sums differ from the JAX package's own eager
  ``describe`` there too). Measured here: 3 of 960 slot-frames single
  (at the one checked, the port equals the JAX package's eager
  ``describe``), 5 of 1,920 for the fleet;
- the stage regions: all twelve in the JAX package's order, and at least 90%
  of a step's host operator time inside them;
- the figure: the decoded PNG equals the rendered array exactly.
"""

import dataclasses
import os
import struct
import textwrap
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models import frontend as jfrontend
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
from larvio_tpu_torch import cli as tcli
from larvio_tpu_torch.config import load_yaml
from larvio_tpu_torch.convert import config_from_dict, from_reference
from larvio_tpu_torch.core.stages import COV_REGIONS, STAGES, STEP, NanCheck
from larvio_tpu_torch.data import visualize
from larvio_tpu_torch.data.export_euroc import export_sim_euroc
from larvio_tpu_torch.data.sim import SimConfig as TSimConfig
from larvio_tpu_torch.models.frontend import track_frame
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step
from tools import torch_trace_analyze as ta

torch.set_num_threads(1)

_S = 320 / 752
_INTR = (458.654, 457.296, 367.215, 248.375)
J_CFG = VioConfig(
    camera=CameraConfig(width=320, height=240, intrinsics=tuple(v * _S for v in _INTR)),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_slam_features=3, max_clones=8, imu_slots_per_frame=14, static_init_samples=60),
)
CFG = config_from_dict(dataclasses.asdict(J_CFG))
START, N_DEBUG = 25, 20  # debug frames [START, START + N_DEBUG) from the tracker state at START
KEYS = ("can_track", "lk_survived", "ransac_survived", "orb_survived", "is_new", "orb_dist")
_S64 = 64 / 752
CUT_YAML = textwrap.dedent(f"""\
    %YAML:1.0
    cam0_resolution: [64, 48]
    cam0_intrinsics: [{", ".join(repr(v * _S64) for v in _INTR)}]
    max_cam_state_size: 6
    max_features_in_state: 0
    pyramid_levels: 1
    grid_row: 2
    grid_col: 2
""")


@pytest.fixture(scope="module")
def seq():
    """50 frames (1 s at rest, then motion), rendered by the JAX package; the
    JAX tracker over them from a fresh state with ``debug=True`` (one jitted
    oracle for one and for two lanes), lane 1 on the frames plus seeded
    2-gray-level noise; from frame ``START`` on, its state before each frame
    (numpy) and its debug outputs."""
    sim = Simulator(SimConfig(duration=2.5, static_lead_in=1.0), J_CFG)
    data = sim.generate()
    imgs = np.asarray(jrender_sequence(J_CFG, sim, data["t_img"]))
    noisy = (imgs + 2.0 * np.random.default_rng(1).standard_normal(imgs.shape)).astype(np.float32)
    step = jax.jit(jax.vmap(partial(jfrontend.track_frame, J_CFG, debug=True)))
    ts = jax.tree.map(lambda a: jnp.stack([a, a]), jfrontend.init_tracker_state(J_CFG))
    bg = jnp.zeros((2, 3), jnp.float32)
    states, masks = [], []
    for k in range(START + N_DEBUG):
        prev = ts
        imu = JImuBatch(*(jnp.asarray(np.stack([data[n][k]] * 2)) for n in ("imu_t", "imu_w", "imu_a", "imu_valid")))
        ts, _, m = step(ts, jnp.asarray(np.stack([imgs[k], noisy[k]])), imu, jnp.asarray(np.stack([data["t_img"][k]] * 2)), bg)
        if k >= START:
            states.append(jax.tree.map(np.asarray, prev))
            masks.append({n: np.asarray(m[n]) for n in KEYS})
    return dict(data=data, imgs=np.stack([imgs, noisy], axis=1), states=states, masks=masks)


def _frame(s, k, lanes):
    d = s["data"]
    pick = (lambda a: np.stack([a] * 2)) if lanes == 2 else np.asarray
    return (torch.from_numpy(s["imgs"][k] if lanes == 2 else s["imgs"][k, 0]),
            ImuBatch(*(torch.from_numpy(pick(d[n][k])) for n in ("imu_t", "imu_w", "imu_a", "imu_valid"))),
            torch.from_numpy(pick(d["t_img"][k])))


@pytest.mark.parametrize("lanes", [1, 2], ids=["single", "fleet"])
def test_track_frame_debug_equals_jax(seq, lanes):
    """20 frames, each from the JAX tracker's state before it, converted
    (step-level parity: over a sequence the two packages' LK positions drift
    apart by ~1e-4 px, enough to flip a descriptor bit now and then): the
    six debug outputs equal the JAX package's exactly, and ``debug=False``
    returns the same state and features."""
    bg = torch.zeros((lanes, 3) if lanes == 2 else (3,))
    n_orb = n_flips = 0
    for j in range(N_DEBUG):
        start = seq["states"][j] if lanes == 2 else jax.tree.map(lambda a: a[0], seq["states"][j])
        ts = from_reference(start, "cpu")
        img, imu, t = _frame(seq, START + j, lanes)
        ts_d, feats_d, m = track_frame(CFG, ts, img, imu, t, bg, debug=True)
        ts, feats = track_frame(CFG, ts, img, imu, t, bg)
        assert set(m) == set(KEYS)
        want = seq["masks"][j] if lanes == 2 else {n: v[0] for n, v in seq["masks"][j].items()}
        for n in KEYS:
            got = m[n].numpy()
            assert got.shape == want[n].shape and got.dtype.kind == want[n].dtype.kind, n
            if n != "orb_dist":
                np.testing.assert_array_equal(got, want[n], err_msg=f"{n}, frame {START + j}")
        d = np.abs(m["orb_dist"].numpy() - want["orb_dist"].astype(np.int64))
        assert d.max() <= 2, f"orb_dist, frame {START + j}: {d.max()} bits from the JAX package's"
        n_flips += int((d > 0).sum())
        assert torch.equal(ts_d.pos, ts.pos) and torch.equal(feats_d.valid, feats.valid)
        assert not (m["orb_survived"] & ~m["ransac_survived"]).any()
        assert not (m["ransac_survived"] & ~m["lk_survived"]).any()
        assert not (m["lk_survived"] & ~m["can_track"]).any()
        n_orb += int(m["orb_survived"].sum())
    assert n_orb > 10 * lanes * N_DEBUG and n_flips <= 0.01 * lanes * N_DEBUG * CFG.frontend.max_features


@pytest.fixture(scope="module")
def step_trace(seq, tmp_path_factory):
    """One port ``pipeline_step`` (after 30 frames: initialized) under the
    CPU profiler, as a chrome trace."""
    d = seq["data"]
    ps = init_pipeline_state(CFG, "cpu")
    frames = [FrameInput(image=torch.from_numpy(seq["imgs"][k, 0]), t=torch.tensor(d["t_img"][k]),
                         imu=ImuBatch(*(torch.from_numpy(d[n][k]) for n in ("imu_t", "imu_w", "imu_a", "imu_valid"))))
              for k in range(31)]
    for fr in frames[:30]:
        ps, out = pipeline_step(CFG, ps, fr)
    assert bool(out.initialized)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline_step(CFG, ps, frames[30])
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    prof.export_chrome_trace(path)
    return ta.load(path)


def test_step_shows_the_twelve_stages_in_order(step_trace):
    """The step and its twelve stages, in order; the covariance regions
    inside the stages (``COV_REGIONS``) are not stages."""
    names = [e["name"] for e in sorted(step_trace, key=lambda e: float(e.get("ts", 0)))
             if e.get("cat") == "user_annotation" and e["name"] not in COV_REGIONS]
    assert names == [STEP, *STAGES]


def test_trace_analyzer_attributes_the_step(step_trace):
    """A CPU trace (no device operations): the step's top-level operator time,
    at least 90% of it inside the twelve stages."""
    res = ta.breakdown(step_trace)
    assert res["mode"] == "host"
    sec = res["eager"]
    assert sec["frames"] == 1 and sec["attributed_share"] >= 0.9
    assert all(sec["stages"][s]["ops"] > 0 for s in STAGES)
    assert "12" not in ta.format_breakdown(res)[:0]  # formats without error


def _device_trace(step_kernels, replay_kernels):
    """A synthetic device trace: one eager step whose kernels each sit in a
    stage (or outside every stage), then graph replays."""
    ev, corr, t = [], 0, 0.0

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1 if cat != "kernel" else 7,
                   "ts": ts, "dur": dur, "args": args})

    x("user_annotation", STEP, 0.0, 1000.0)
    for name, stage in step_kernels:
        corr += 1
        if stage:
            x("user_annotation", stage, t + 1, 5.0)
        x("cuda_runtime", "cudaLaunchKernel", t + 2, 1.0, correlation=corr)
        x("kernel", name, 5000.0 + t, 2.0, correlation=corr)
        t += 10
    for names in replay_kernels:
        corr += 1
        x("cuda_runtime", "cudaGraphLaunch", 2000.0 + t, 1.0, correlation=corr)
        for name in names:
            x("kernel", name, 5000.0 + t, 3.0, correlation=corr)
            t += 10
    corr += 1
    x("kernel", "Memcpy HtoD", 9000.0, 1.0, correlation=corr)  # no runtime call recorded
    return ev


_EW = "void at::native::{}elementwise_kernel<{}at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>{}>(int)"


def test_trace_analyzer_maps_replays_by_position_only_where_names_match():
    """Replays map onto the eager step where the names match after folding
    the launch variants of one operation (a graph's copy and fill nodes, an
    elementwise kernel's vector width); otherwise they stay unattributed."""
    step = [("pyr_k", "fe.pyramid"), ("lk_track_kernel", "fe.lk"), ("glue", None),
            ("orb_describe_kernel", "fe.orb"), ("qr", "filt.marginalize"),
            ("Memcpy DtoD (Device -> Device)", "filt.zupt"), (_EW.format("unrolled_", "", ", 4, X"), "filt.zupt")]
    names = [n for n, _ in step[:5]] + ["memcpy32_post", _EW.format("vectorized_", "4, ", " ")]
    res = ta.breakdown(_device_trace(step, [names + ["copy", "copy"], names + ["copy"]]))
    eager, cap = res["eager"], res["captured"]
    assert res["mode"] == "device" and eager["frames"] == 1 and cap["frames"] == 2
    assert eager["stages"]["fe.lk"]["ops"] == 1 and eager["stages"]["unattributed"]["ops"] == 1
    assert eager["attributed_share"] == pytest.approx(6 / 7)
    assert ta.kernel_stages(res, "lk_track_kernel") == {"fe.lk": 1}
    assert ta.kernel_stages(res, "lk_track_kernel", "captured") == {"fe.lk": 2}
    assert cap["stages"][ta.GRAPH_TAIL]["ops"] == 1.5 and not res["note"]
    assert len(res["rows"]["outside"]) == 1
    # a replay whose sequence is not the eager step's is not guessed: left
    # out beside a mapped one, the replays unattributed where none maps
    odd = names[:2] + ["other"] + names[3:]
    res = ta.breakdown(_device_trace(step, [odd, names + ["copy"]]))
    assert res["note"].startswith("1 of 2 replays not mapped") and "operation 2 (other) differs" in res["note"]
    assert res["captured"]["frames"] == 1 and len(res["rows"]["unmapped"]) == len(odd)
    res = ta.breakdown(_device_trace(step, [odd]))
    assert res["note"].startswith("1 of 1 replays") and res["captured"]["attributed_share"] == 0.0
    assert ta.op_key("memset32") == ta.op_key("Memset (Device)") != ta.op_key("memcpy_post")
    # a trace of replays only, mapped onto eager steps from another trace
    refs = [[("x", "fe.lk")], [(n, s or ta.UNATTRIBUTED) for n, s in step]]
    only = [e for e in _device_trace(step, [names]) if e["args"].get("correlation", 0) > len(step)]
    res = ta.breakdown(only, references=refs)
    assert res["eager"] is None and res["captured"]["stages"]["fe.orb"]["ops"] == 1


def test_trace_analyzer_maps_a_replay_short_of_records():
    """A replay that lacks a run of records, every other one in order, maps
    onto a full replay of the same graph, its missing records counted with
    the device records of other launches inside its span; a replay with a
    foreign record in place of its own stays unmapped."""
    step = [("pyr_k", "fe.pyramid"), ("lk_track_kernel", "fe.lk"), ("glue", None),
            ("orb_describe_kernel", "fe.orb"), ("qr", "filt.marginalize"), ("zupt_k", "filt.zupt")]
    names = [n for n, _ in step] + ["copy", "copy"]
    short = names[:1] + names[3:]  # two records missing at operation 1
    ev = _device_trace(step, [names, short, names])
    res = ta.breakdown(ev)
    assert not res["rows"]["unmapped"] and res["captured"]["frames"] == 3
    assert res["short"] == [(1, 1, 2, 0)] and "replay 1 mapped short of 2 records at operation 1" in res["note"]
    assert ta.kernel_stages(res, "orb_describe_kernel", "captured") == {"fe.orb": 3}
    assert ta.kernel_stages(res, "lk_track_kernel", "captured") == {"fe.lk": 2}
    # a record of another launch inside the short replay's span is counted
    lo = min(e["ts"] for e in ev if e["name"] == "orb_describe_kernel" and e["ts"] > 5000.0 + 10 * len(step) + 10 * len(names))
    ev.append({"ph": "X", "cat": "kernel", "name": "stray", "pid": 1, "tid": 7, "ts": lo + 1.0, "dur": 1.0,
               "args": {"correlation": 10_000}})
    assert ta.breakdown(ev)["short"] == [(1, 1, 2, 1)]
    odd = names[:1] + ["other"] + names[3:]
    res = ta.breakdown(_device_trace(step, [names, odd]))
    assert res["note"].startswith("1 of 2 replays not mapped") and not res["short"]


def test_nan_check_holds_outputs_under_their_masks():
    chk = NanCheck()
    x = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    chk("fe.lk", pos=(x, torch.tensor([False, True])), scalar=torch.tensor(1.0))
    chk.frame = 7
    with pytest.raises(FloatingPointError, match="stage fe.lk produced a non-finite pos at frame 7"):
        chk("fe.lk", pos=(x, torch.tensor([True, True])))
    with pytest.raises(FloatingPointError, match="filt.zupt"):
        chk("filt.zupt", P=torch.tensor(float("inf")))


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """1.6 s (32 frames) at 64x48, exported by the port; the static
    initializer fires at frame 21."""
    root = tmp_path_factory.mktemp("tiny")
    (root / "cut.yaml").write_text(CUT_YAML)
    export_sim_euroc(str(root / "tree"), load_yaml(str(root / "cut.yaml")), TSimConfig(duration=1.6),
                     device="cpu")
    return root


def test_debug_nans_names_the_stage_of_a_nan_accelerometer_row(tiny_tree, tmp_path):
    """A NaN accelerometer sample after initialization: ``--debug-nans``
    raises at ``filt.propagate``, naming the frame; the plain run contains it
    (online reset) and finishes."""
    bad = tmp_path / "bad"
    csv = "mav0/imu0/data.csv"
    for sub in ("mav0/cam0", "mav0/state_groundtruth_estimate0"):
        (bad / sub).parent.mkdir(parents=True, exist_ok=True)
        os.symlink(tiny_tree / "tree" / sub, bad / sub)
    (bad / csv).parent.mkdir(parents=True)
    lines = (tiny_tree / "tree" / csv).read_text().splitlines()
    k = [i for i, ln in enumerate(lines) if not ln.startswith("#")][int(0.8 * (len(lines) - 1))]
    f = lines[k].split(",")
    f[4] = "nan"
    lines[k] = ",".join(f)
    (bad / csv).write_text("\n".join(lines) + "\n")
    argv = ["run", str(tiny_tree / "cut.yaml"), str(bad), "--device", "cpu", "--out", str(tmp_path / "t.txt")]
    with pytest.raises(FloatingPointError, match=r"stage filt\.propagate produced a non-finite \w+ at frame 2\d"):
        tcli.main(["--debug-nans", *argv])
    assert tcli.main(argv) == 0


def test_cli_live_refreshes_its_png(tiny_tree, tmp_path, capsys):
    """``run --live PNG --live-every 8``: the trajectory-so-far figure is
    written during the run and rewritten by a second run, with a status line
    per refresh (``tests/test_data_utils.py``'s check of the JAX CLI)."""
    png_path = tmp_path / "live.png"
    argv = ["run", str(tiny_tree / "cut.yaml"), str(tiny_tree / "tree"), "--device", "cpu",
            "--live", str(png_path), "--live-every", "8", "--out", str(tmp_path / "t.txt")]
    assert tcli.main(argv) == 0
    assert png_path.stat().st_size > 1000
    first = png_path.stat().st_mtime_ns
    assert tcli.main(argv) == 0
    assert png_path.stat().st_mtime_ns >= first
    assert capsys.readouterr().out.count("live: frame ") == 8


def _decode(data: bytes) -> tuple:
    """(RGB array, tEXt chunks) of an Up-row RGB PNG, decoded here with zlib."""
    pos, idat, text, hdr = 8, [], {}, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            k, v = body.split(b"\0")
            text[k.decode()] = v.decode("latin-1")
        pos += 12 + n
    W, H, depth, colour = hdr[:4]
    assert (depth, colour) == (8, 2)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 3 * W + 1)
    assert (raw[:, 0] == 2).all()  # Up rows
    return np.cumsum(raw[:, 1:], axis=0, dtype=np.uint8).reshape(H, W, 3), text


def test_plot_run_writes_the_figure_it_renders(tmp_path):
    """The PNG decodes (zlib, here) to the rendered (1056, 1210, 3) figure;
    the estimate's colour lies at (or next to) the pixels its positions map
    to in the top-down and altitude panels; the title is a tEXt chunk."""
    T = 120
    t = np.arange(T) / 20.0
    p = np.stack([np.cos(t), np.sin(t), 0.2 * t], axis=1)
    gt = p + 0.02
    stats = {"tracks": np.full(T, 40), "clones": np.arange(T) % 9, "updated": np.arange(T) % 5,
             "zupt": np.zeros(T, bool), "resets": np.zeros(T, bool)}
    frame = np.tile(np.arange(64, dtype=np.float64) * 4, (48, 1))
    pts, valid = np.array([[10.0, 10.0], [50.0, 30.0], [30.0, 20.0]]), np.array([True, True, False])
    path = str(tmp_path / "fig.png")
    assert visualize.plot_run(path, t, p, gt, stats, frame, pts, valid, title="run 7") == path
    img, axes = visualize.render_run(t, p, gt, stats, frame, pts, valid)
    got, text = _decode(open(path, "rb").read())
    assert got.shape == (3 * visualize.ROW_H, visualize.FIG_W, 3) and np.array_equal(got, img)
    assert text == {"Title": "run 7"}
    est = np.array(visualize.rgb(visualize.C_EST), np.uint8)
    for name, (x, y) in (("top-down", (p[1:, 0], p[1:, 1])), ("altitude", (t, p[:, 2]))):
        u, v = (np.rint(a).astype(int) for a in axes[name].px(x, y))
        near = np.zeros(len(u), bool)
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                near |= (got[v + dv, u + du] == est).all(-1)
        assert near.mean() > 0.98, name
    u, v = (np.rint(a).astype(int) for a in axes["overlay"].px(pts[:, 0], pts[:, 1]))
    ring = (got[v, u + 3] == np.array(visualize.rgb(visualize.C_FEAT), np.uint8)).all(-1)
    assert ring.tolist() == [True, True, False]  # the invalid slot is not drawn


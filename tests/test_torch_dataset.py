"""The port's dataset entry path against the JAX package: the PNG codec
(the port's substitute for cv2), the EuRoC reader, the EuRoC export, TUM
output, checkpoints crossing between the packages, the feature-level API and
the CLI.

Tolerances:
- PNG decode: equal to ``cv2.imread`` exactly, every row filter;
- EuRoC frames (IMU arrays, validity, stamps, images), TUM files and the
  export's CSVs: exact; ground truth within 1e-12;
- the export's PNGs within 1 gray level of the JAX export's, on < 1% of
  the pixels (the float renders agree to ~1e-3 gray,
  ``tests/test_torch_render.py``, and a pixel within that of an integer can
  truncate to the neighbouring uint8; measured at 64x48 over 20 frames: no
  pixel differs);
- checkpoints: exact both ways;
- ``api.run_feature_sequence``: positions within 1e-3 m, ``initialized``
  exact (the feature-level filter tests' bar, ``tests/test_torch_fleet.py``).
"""

import dataclasses
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import jax
import numpy as np
import pytest
import torch

import larvio_tpu.api as japi
import larvio_tpu.cli as jcli
import larvio_tpu.data.euroc as jeuroc
import larvio_tpu.data.export_euroc as jexport
import larvio_tpu.data.trajectory as jtraj
import larvio_tpu.pipeline as jpipe
import larvio_tpu.utils.checkpoint as jckpt
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu_torch import api as tapi
from larvio_tpu_torch import cli as tcli
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.data import euroc as teuroc
from larvio_tpu_torch.data import export_euroc as texport
from larvio_tpu_torch.data import png as tpng
from larvio_tpu_torch.data import sim as tsim
from larvio_tpu_torch.data import trajectory as ttraj
from larvio_tpu_torch.config import load_yaml as tcfg_load
from larvio_tpu_torch.pipeline import init_pipeline_state
from larvio_tpu_torch.utils import checkpoint as tckpt
from larvio_tpu_torch.utils import native as tnative

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
K_CHUNK = 4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_INTR = (458.654, 457.296, 367.215, 248.375)
_S = 64 / 752
SMALL = VioConfig(camera=CameraConfig(width=64, height=48, intrinsics=tuple(v * _S for v in _INTR)))
# the CLI's cut camera: reference-style YAML keys only (no feature-count key)
CUT_YAML = textwrap.dedent(f"""\
    %YAML:1.0
    cam0_resolution: [64, 48]
    cam0_intrinsics: [{", ".join(repr(v * _S) for v in _INTR)}]
    max_cam_state_size: 6
    max_features_in_state: 0
    pyramid_levels: 1
    grid_row: 2
    grid_col: 2
""")


# --------------------------------------------------------------------------
# PNG codec
# --------------------------------------------------------------------------


def _texture(H, W, seed=0):
    """A smooth image with noise, as a camera gives (cv2 picks Paeth/Average)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = 120 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0) + rng.normal(0, 3, (H, W))
    return np.clip(img, 0, 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(img, ftypes):
    """The PNG specification's filters, one pixel at a time (the reference
    the vectorized decoder is held to)."""
    H, W = img.shape
    x = img.astype(int)
    out = np.zeros((H, W + 1), np.uint8)
    for r in range(H):
        out[r, 0] = ftypes[r]
        for c in range(W):
            a = x[r, c - 1] if c else 0
            b = x[r - 1, c] if r else 0
            ul = x[r - 1, c - 1] if r and c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, ul))[ftypes[r]]
            out[r, c + 1] = (x[r, c] - pred) % 256
    return out


def _png_file(raw_rows, W, H, depth=8, colour=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw_rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(48, 64), (1, 1), (7, 300)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    tpng.write_png_gray(path, img)
    np.testing.assert_array_equal(tpng.read_png_gray(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)


def _row_filters(data: bytes, H: int, W: int) -> np.ndarray:
    idat = b"".join(body for kind, body in tpng._chunks(data) if kind == b"IDAT")
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W + 1)[:, 0]


@pytest.mark.parametrize("case", ["default", "adaptive", "adaptive_noisy"])
def test_png_reads_cv2_files_exactly(tmp_path, case):
    """cv2's default writes every row with Sub; an explicit compression level
    makes libpng pick each row's filter: the texture comes out with all of
    Sub, Up, Average and Paeth, the noisier one mostly Average."""
    rng = np.random.default_rng(2)
    img = _texture(120, 160)
    if case == "adaptive_noisy":
        img = np.clip(img + rng.normal(0, 3.0, img.shape), 0, 255).astype(np.uint8)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img, [] if case == "default" else [cv2.IMWRITE_PNG_COMPRESSION, 3])
    used = set(_row_filters(open(path, "rb").read(), 120, 160).tolist())
    assert used == {1} if case == "default" else {3, 4} <= used
    np.testing.assert_array_equal(tpng.read_png_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("ftypes", ["0", "1", "2", "3", "4", "mixed"])
def test_png_each_row_filter(ftypes):
    img = _texture(23, 31, seed=3)
    H, W = img.shape
    f = (np.arange(H) % 5 if ftypes == "mixed" else np.full(H, int(ftypes))).astype(int)
    data = _png_file(_filter_rows(img, f), W, H)
    np.testing.assert_array_equal(tpng.decode_png_gray(data), img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE), img)


@pytest.mark.parametrize("case", ["adaptive", "adaptive_noisy", "random"])
def test_png_c_unfilter_matches_the_wavefront(tmp_path, case):
    """The C unfilter (the decoder's path for every file) against
    the numpy wavefront it replaced, on cv2-written adaptive-filter files at
    752x480, and on random bytes under every filter: equal exactly."""
    rng = np.random.default_rng(4)
    if case == "random":
        rows = rng.integers(0, 256, (61, 97), dtype=np.uint8)
        ftype = rng.integers(0, 5, 61).astype(np.uint8)
        want = tpng._unfilter_wavefront(rows, ftype)
    else:
        img = _texture(480, 752, seed=5)
        if case == "adaptive_noisy":
            img = np.clip(img + rng.normal(0, 3.0, img.shape), 0, 255).astype(np.uint8)
        path = str(tmp_path / "cv.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 3])
        data = open(path, "rb").read()
        idat = b"".join(body for kind, body in tpng._chunks(data) if kind == b"IDAT")
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(480, 753)
        rows, ftype = raw[:, 1:], raw[:, 0]
        assert {3, 4} & set(ftype.tolist())  # Average or Paeth rows
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(tpng._unfilter_wavefront(rows, ftype), want)
        np.testing.assert_array_equal(tpng.decode_png_gray(data), want)
    np.testing.assert_array_equal(tpng._unfilter_c(rows, ftype), want)


def test_png_c_unfilter_refuses_and_never_falls_back(monkeypatch):
    """An unknown filter raises; a failed build raises (no numpy path)."""
    with pytest.raises(ValueError, match="row filter 5"):
        tpng._unfilter_c(np.zeros((2, 3), np.uint8), np.array([0, 5], np.uint8))
    monkeypatch.setattr(tpng, "_lib", None)
    monkeypatch.setattr(tpng, "_C_FLAGS", tpng._C_FLAGS + ["-DLARVIO_UNBUILT"])
    monkeypatch.setattr(tnative, "_compiler", lambda cxx: "false")
    data = _png_file(_filter_rows(_texture(5, 6), np.full(5, 4)), 6, 5)
    with pytest.raises(RuntimeError, match="C build failed"):
        tpng.decode_png_gray(data)


@pytest.mark.parametrize("kind", ["rgb", "16bit", "bad_crc", "not_png", "bad_filter"])
def test_png_rejects_what_it_does_not_read(tmp_path, kind):
    img = _texture(12, 16)
    path = str(tmp_path / "x.png")
    if kind == "rgb":
        cv2.imwrite(path, np.stack([img] * 3, axis=-1))
    elif kind == "16bit":
        cv2.imwrite(path, img.astype(np.uint16) * 257)
    else:
        raw = _filter_rows(img, np.zeros(12, int))
        if kind == "bad_filter":
            raw[7, 0] = 5  # no such row filter
        data = bytearray(_png_file(raw, 16, 12))
        if kind == "bad_crc":
            data[29] ^= 1  # last CRC byte of IHDR
        elif kind == "not_png":
            data[1] = ord("Q")
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        tpng.read_png_gray(path)


# --------------------------------------------------------------------------
# EuRoC reader (the fake tree of tests/test_data_utils.py, plus ground truth)
# --------------------------------------------------------------------------


@pytest.fixture
def fake_euroc(tmp_path):
    rng = np.random.default_rng(0)
    mav = tmp_path / "mav0"
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "imu0").mkdir(parents=True)
    (mav / "state_groundtruth_estimate0").mkdir(parents=True)
    t0 = 1403636579763555584
    stamps = [t0 + int(i * 50e6) for i in range(10)]
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for s in stamps:
            f.write(f"{s},{s}.png\n")
            img = (rng.uniform(0, 255, (48, 64))).astype(np.uint8)
            cv2.imwrite(str(mav / "cam0" / "data" / f"{s}.png"), img)
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],wx,wy,wz,ax,ay,az\n")
        t = t0 - int(50e6)
        while t < stamps[-1] + int(100e6):
            f.write(f"{t},0.01,-0.02,0.005,0.1,-0.05,9.8\n")
            t += int(5e6)
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for i in range(0, 60):
            f.write(f"{t0 + int(i * 10e6)},{0.1 * i:.6f},{np.sin(i / 7):.6f},{0.01 * i * i:.6f},1,0,0,0\n")
    return tmp_path


def _frames_equal(a, b, image_atol=0):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k == "image" and image_atol:
                assert np.abs(x.astype(int) - y.astype(int)).max() <= image_atol
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_euroc_frames_match_jax(fake_euroc):
    jcfg = VioConfig(camera=CameraConfig(width=64, height=48))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    js, ts = jeuroc.EurocSequence(str(fake_euroc)), teuroc.EurocSequence(str(fake_euroc))
    assert ts.t0 == js.t0
    np.testing.assert_array_equal(ts.image_stamps, js.image_stamps)
    for kw in (dict(), dict(max_frames=4, skip_frames=3)):
        want = list(js.frames(jcfg, **kw))
        _frames_equal(list(ts.frames(tcfg, **kw)), want)
        lazy = [dict(f, image=f["image"]()) for f in ts.frames(tcfg, lazy=True, **kw)]
        _frames_equal(lazy, want)
    assert len(want) == 4 and want[0]["image"].dtype == np.uint8
    t = np.linspace(-0.1, 0.7, 33)
    np.testing.assert_allclose(ts.ground_truth_at(t), js.ground_truth_at(t), rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# EuRoC export: 1 s at 64x48 from each package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    sc = dict(duration=1.0, seed=3)
    jexport.export_sim_euroc(str(root / "jax"), SMALL, SimConfig(**sc))
    n = texport.export_sim_euroc(str(root / "port"), config_from_dict(dataclasses.asdict(SMALL)),
                                 tsim.SimConfig(**sc), device="cpu")
    assert n == 20
    return root / "jax", root / "port"


_CSVS = ("mav0/cam0/data.csv", "mav0/imu0/data.csv", "mav0/state_groundtruth_estimate0/data.csv")


def test_export_csvs_byte_identical(exports):
    jroot, troot = exports
    for name in _CSVS:
        assert (troot / name).read_bytes() == (jroot / name).read_bytes(), name


def test_export_pngs_within_one_gray_level(exports):
    jroot, troot = exports
    names = sorted(os.listdir(jroot / "mav0/cam0/data"))
    assert names == sorted(os.listdir(troot / "mav0/cam0/data")) and len(names) == 20
    diff = np.stack([
        tpng.read_png_gray(str(troot / "mav0/cam0/data" / n)).astype(int)
        - cv2.imread(str(jroot / "mav0/cam0/data" / n), cv2.IMREAD_GRAYSCALE).astype(int)
        for n in names])
    assert np.abs(diff).max() <= 1
    share = float((diff != 0).mean())
    print(f"export PNGs: {share:.6f} of the pixels one gray level apart")
    assert share < 0.01


def test_export_tree_reads_the_same_in_both_packages(exports):
    jroot, troot = exports
    tcfg = config_from_dict(dataclasses.asdict(SMALL))
    # the port's tree through both readers: identical frames
    _frames_equal(list(teuroc.EurocSequence(str(troot)).frames(tcfg)),
                  list(jeuroc.EurocSequence(str(troot)).frames(SMALL)))
    # each package's own tree: identical IMU, images within 1 gray level
    _frames_equal(list(teuroc.EurocSequence(str(troot)).frames(tcfg)),
                  list(jeuroc.EurocSequence(str(jroot)).frames(SMALL)), image_atol=1)
    t = np.linspace(0.0, 0.95, 20)
    np.testing.assert_array_equal(teuroc.EurocSequence(str(troot)).ground_truth_at(t),
                                  jeuroc.EurocSequence(str(jroot)).ground_truth_at(t))


# --------------------------------------------------------------------------
# TUM output
# --------------------------------------------------------------------------


def test_tum_byte_identical_and_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    n = 25
    t = np.cumsum(rng.uniform(0.04, 0.06, n)).astype(np.float32)
    p = rng.normal(0, 3, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jtraj.write_tum(str(tmp_path / "j.txt"), t, p, q)
    ttraj.write_tum(str(tmp_path / "t.txt"), t, p, q)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    t2, p2, q2 = ttraj.read_tum(str(tmp_path / "t.txt"))
    np.testing.assert_allclose(t2, t, atol=5e-10)
    np.testing.assert_allclose(p2, p, atol=5e-7)
    np.testing.assert_allclose(q2, q, atol=5e-7)
    ttraj.write_tum(str(tmp_path / "one.txt"), t[:1], p[:1], q[:1])
    assert ttraj.read_tum(str(tmp_path / "one.txt"))[1].shape == (1, 3)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

_CK_CFG = VioConfig(
    camera=CameraConfig(width=160, height=120, intrinsics=tuple(v * 160 / 752 for v in _INTR)),
    frontend=FrontendConfig(max_features=24, grid_rows=2, grid_cols=2, pyramid_levels=2),
    filter=FilterConfig(max_clones=4, max_slam_features=2, imu_slots_per_frame=14),
)


def _random_jax_state(seed):
    """A JAX PipelineState whose every leaf holds random values of its dtype
    (the descriptor words with their high bits set), so a leaf in the wrong
    place cannot pass."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rng.integers(0, 2, a.shape).astype(bool)
        if a.dtype == np.uint32:
            return rng.integers(2**31, 2**32, a.shape, dtype=np.uint64).astype(np.uint32)
        if a.dtype.kind == "i":
            return rng.integers(-5, 1000, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    return jax.tree.map(fill, jpipe.init_pipeline_state(_CK_CFG))


def _assert_tree_equal(got_numpy, want_numpy):
    assert jax.tree.structure(got_numpy) == jax.tree.structure(want_numpy)
    for a, b in zip(jax.tree.leaves(got_numpy), jax.tree.leaves(want_numpy)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_round_trip_exact(tmp_path):
    tcfg = config_from_dict(dataclasses.asdict(_CK_CFG))
    st = from_reference(_random_jax_state(6), "cpu")
    path = tckpt.save_state(str(tmp_path / "ck"), st)
    assert path.endswith("ck.npz") and os.path.exists(path)
    back = tckpt.restore_state(str(tmp_path / "ck"), init_pipeline_state(tcfg, "cpu"))
    _assert_tree_equal(to_reference_numpy(back), to_reference_numpy(st))
    with pytest.raises(ValueError):
        tckpt.restore_state(path, init_pipeline_state(tcfg, "cpu").vio)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    tcfg = config_from_dict(dataclasses.asdict(_CK_CFG))
    ref = _random_jax_state(7 if writer == "jax" else 8)
    path = str(tmp_path / "x.npz")
    if writer == "jax":
        jckpt.save_state(path, ref)
        got = tckpt.restore_state(path, init_pipeline_state(tcfg, "cpu"))
        _assert_tree_equal(to_reference_numpy(got), to_reference_numpy(from_reference(ref, "cpu")))
    else:
        tckpt.save_state(path, from_reference(ref, "cpu"))
        got = jckpt.restore_state(path, jpipe.init_pipeline_state(_CK_CFG))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------------
# Feature-level API
# --------------------------------------------------------------------------


def test_run_feature_sequence_matches_jax():
    cfg = VioConfig(filter=FilterConfig(max_clones=8, max_update_features=12, imu_slots_per_frame=24,
                                        max_slam_features=0),
                    frontend=FrontendConfig(max_features=48))
    data = Simulator(SimConfig(duration=2.5, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05,
                               seed=1), cfg).generate()
    _, oj = japi.run_feature_sequence(cfg, data)
    vs, ot = tapi.run_feature_sequence(config_from_dict(dataclasses.asdict(cfg)), data, device="cpu")
    assert isinstance(ot.p, np.ndarray) and ot.p.shape == np.asarray(oj.p).shape
    np.testing.assert_array_equal(ot.initialized, np.asarray(oj.initialized))
    assert ot.initialized.sum() >= 20
    np.testing.assert_allclose(ot.p, np.asarray(oj.p), rtol=0, atol=1e-3)
    assert vs.filter.P.device.type == "cpu"


def test_api_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.make_frame_inputs({"ids": np.zeros(3)}, 0)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_run_writes_trajectory_and_metrics(tmp_path, capsys):
    """1.5 s of the static lead-in: the static initializer fires after its
    200 IMU samples (1 s)."""
    yml = tmp_path / "cut.yaml"
    yml.write_text(CUT_YAML)
    troot = tmp_path / "tree"
    texport.export_sim_euroc(str(troot), config_from_dict(dataclasses.asdict(SMALL)),
                             tsim.SimConfig(duration=1.5), device="cpu")
    out, metrics, ck = tmp_path / "traj.txt", tmp_path / "m.csv", tmp_path / "state"
    rc = tcli.main(["run", str(yml), str(troot), "--device", "cpu", "--out", str(out),
                    "--metrics", str(metrics), "--eval", "--budget", "--checkpoint", str(ck)])
    assert rc == 0
    rows = metrics.read_text().splitlines()
    assert rows[0] == "t,initialized,tracks,clones,updated,zupt,reset"
    table = np.array([[float(x) for x in r.split(",")] for r in rows[1:]])
    assert table.shape == (30, 7)
    n_init = int(table[:, 1].sum())
    assert n_init >= 5
    traj = out.read_text().splitlines()
    assert len(traj) == n_init and all(len(line.split()) == 8 for line in traj)
    assert os.path.exists(str(ck) + ".npz")
    text = capsys.readouterr().out
    assert "budget ms/frame: decode=" in text and "ATE RMSE vs ground truth" in text


def test_cli_runs_on_the_card_unless_told_otherwise(exports):
    _, troot = exports
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tcli.main(["run", "-", str(troot)])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tcli.main(["export-sim", "unused_dir", "--duration", "0.1"])


@pytest.mark.parametrize("flags", [["run", "--plot"], ["run", "--live", "--live-every", "8"],
                                   ["--debug-nans", "run"], ["sim", "--plot"]],
                         ids=["run-plot", "run-live", "debug-nans", "sim-plot"])
def test_cli_offers_the_jax_clis_flags(flags, chunk_trees, tmp_path, capsys):
    """``run --plot``, ``run --live --live-every``, ``--debug-nans run`` and
    ``sim --plot`` parse and run on the CPU: each figure is an RGB PNG of the
    summary's width, and the ``--debug-nans`` run writes the plain run's TUM
    file byte for byte."""
    png_path, out = tmp_path / "fig.png", tmp_path / "traj.txt"
    argv = [f if f not in ("--plot", "--live") else f"{f}={png_path}" for f in flags]
    if "run" in flags:
        argv += [str(chunk_trees / "cut.yaml"), str(chunk_trees / "port")]
    else:
        argv += ["--duration", "0.2"]
    assert tcli.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    if "--debug-nans" in flags:
        assert "--debug-nans: every stage's outputs are held to torch.isfinite" in text
        plain = tmp_path / "plain.txt"
        assert tcli.main(argv[1:] + ["--device", "cpu", "--out", str(plain)]) == 0
        assert out.read_bytes() == plain.read_bytes() and len(out.read_bytes()) > 0
        return
    data = png_path.read_bytes()
    W, H, depth, colour = struct.unpack(">IIBB", data[16:26])
    assert (W, depth, colour) == (1210, 8, 2) and H in (704, 1056)
    if "--live" in flags:
        assert text.count("live: frame ") == 4  # frames 8, 16, 24, 32
    else:
        assert f"plot -> {png_path}" in text


@pytest.fixture(scope="module")
def chunk_trees(tmp_path_factory):
    """1.6 s (32 frames) at 64x48 exported by each package, and the CLI's cut
    YAML: the static initializer fires at frame 21, so ``--chunk 4`` steps
    frames 22-29 in two chunks and drains the last two one at a time."""
    root = tmp_path_factory.mktemp("chunk")
    sc = dict(duration=1.6, seed=0)
    jexport.export_sim_euroc(str(root / "jax"), SMALL, SimConfig(**sc))
    texport.export_sim_euroc(str(root / "port"), config_from_dict(dataclasses.asdict(SMALL)),
                             tsim.SimConfig(**sc), device="cpu")
    (root / "cut.yaml").write_text(CUT_YAML)
    return root


def test_cli_chunk_equals_one_frame_at_a_time_and_matches_jax(chunk_trees):
    """``run --chunk 4`` writes ``--chunk 1``'s TUM file byte for byte, and
    matches the JAX CLI's ``--chunk 4`` (one compiled scan per chunk) on the
    JAX package's export: the same initialized frames, stamps within 1e-5 s,
    positions within 1 cm (``tests/test_torch_init.py``'s CLI bound)."""
    yml = str(chunk_trees / "cut.yaml")
    tum = {}
    for k in (1, 4):
        out = chunk_trees / f"port_chunk{k}.txt"
        assert tcli.main(["run", yml, str(chunk_trees / "port"), "--device", "cpu", "--chunk", str(k),
                          "--out", str(out)]) == 0
        tum[k] = out.read_bytes()
    assert tum[4] == tum[1]
    jout = chunk_trees / "jax_chunk4.txt"
    assert jcli.main(["run", yml, str(chunk_trees / "jax"), "--chunk", "4", "--out", str(jout)]) == 0
    tt, pt, _ = ttraj.read_tum(str(chunk_trees / "port_chunk4.txt"))
    tj, pj, _ = jtraj.read_tum(str(jout))
    assert 8 <= len(tt) == len(tj)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-5)
    assert np.abs(pt - pj).max() < 0.01


def test_cli_chunk_resume_equals_uninterrupted(chunk_trees, tmp_path):
    """``--chunk 4`` with a checkpoint after frame 25 (initialized), then the
    rest resumed with ``--chunk 4``: the stitched run equals the
    uninterrupted chunked run exactly (one pass of the reader, split)."""
    cfg = tcfg_load(str(chunk_trees / "cut.yaml"))
    frames = list(teuroc.EurocSequence(str(chunk_trees / "port")).frames(cfg, lazy=True))
    full = tcli._run_streaming(cfg, iter(frames), device="cpu", chunk=K_CHUNK)
    ck = str(tmp_path / "ck")
    a = tcli._run_streaming(cfg, iter(frames[:25]), device="cpu", chunk=K_CHUNK, checkpoint=ck)
    assert a[3].any()  # initialized before the checkpoint
    b = tcli._run_streaming(cfg, iter(frames[25:]), device="cpu", chunk=K_CHUNK, resume=ck)
    for i in range(4):  # t, p, q, initialized
        np.testing.assert_array_equal(np.concatenate([a[i], b[i]]), full[i])
    assert torch.equal(b[6].vio.filter.P, full[6].vio.filter.P)


def test_cli_needs_no_cv2_matplotlib_or_jax(tmp_path):
    """A process that blocks cv2, matplotlib, PIL and JAX exports a 64x48
    tree and runs it through ``cli.main`` on the CPU."""
    (tmp_path / "cut.yaml").write_text(CUT_YAML)
    code = textwrap.dedent(f"""
        import sys
        _BLOCK = ("cv2", "matplotlib", "PIL", "jax", "jaxlib", "flax", "larvio_tpu")

        class _Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in _BLOCK:
                    raise ImportError("blocked import of " + name)

        sys.meta_path.insert(0, _Blocker())
        import torch
        torch.set_num_threads(1)
        from larvio_tpu_torch import cli
        from larvio_tpu_torch.config import load_yaml
        from larvio_tpu_torch.data.export_euroc import export_sim_euroc
        from larvio_tpu_torch.data.sim import SimConfig
        root = {str(tmp_path / "tree")!r}
        export_sim_euroc(root, load_yaml({str(tmp_path / "cut.yaml")!r}), SimConfig(duration=0.5), device="cpu")
        assert cli.main(["run", {str(tmp_path / "cut.yaml")!r}, root, "--device", "cpu",
                         "--out", {str(tmp_path / "t.txt")!r}]) == 0
        print("NO_CV2_OK")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PALLAS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0 and "NO_CV2_OK" in proc.stdout, proc.stdout + proc.stderr

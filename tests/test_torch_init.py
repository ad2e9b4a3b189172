"""The port's flexible (in-motion) initialization and streaming entry point
against the JAX package.

Both packages get the same numpy inputs: the simulator's feature tracks
(the JAX package's own ``tests/test_dynamic_init.py`` setups) and frames
rendered by the JAX package at a cut camera (320x240, intrinsics scaled),
cast to uint8 as a dataset's PNGs are. The port's config is rebuilt from the
JAX one's dict.

Tolerances:
- ``FlexibleInitializer``: the same mode at the same frame; bg, v and q_wi
  within 1e-5 (host numpy float64 on both sides, the quaternions in float32);
- ``inject_init_result``: nominal fields equal up to float32, P = S S^T
  within 1e-6;
- ``run_image_sequence_flexible`` (a moving start, 50 frames) and the CLI's
  ``_run_streaming`` in ``static`` and ``auto`` modes: the same initialized
  frames (dynamic where the JAX package initializes dynamically), positions
  within 1 cm (``tests/test_torch_pipeline.py``'s bound). Measured on this
  configuration (CPU): both packages inject a dynamic result at frame 16 of
  the flexible run (the CLI's stricter parallax gate: frame 21), positions
  within 1e-4 m;
- resume from a checkpoint equals the uninterrupted run exactly (the JAX
  package's bar, ``tests/test_data_utils.py``, is 1e-4 m).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.cli as jcli
import larvio_tpu.init.flexible as jflex
import larvio_tpu.pipeline as jpipe
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.evaluate import ate_rmse
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models.msckf import init_vio_state as jinit_vio_state
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
import larvio_tpu_torch.cli as tcli
import larvio_tpu_torch.init.flexible as tflex
import larvio_tpu_torch.pipeline as tpipe
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.models.propagation import ImuBatch

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_clones=8, max_slam_features=3, imu_slots_per_frame=14),
)
TCFG = config_from_dict(dataclasses.asdict(CFG))
GYRO_BIAS = (0.01, -0.02, 0.015)


def _push_all(ini, data):
    """Feed every frame of a feature-level sim to an initializer until it
    fires; returns (frame, result)."""
    for k in range(len(data["t_img"])):
        ini.push(data["t_img"][k], data["ids"][k], data["uv"][k], data["fvalid"][k],
                 data["imu_t"][k], data["imu_w"][k], data["imu_a"][k], data["imu_valid"][k])
        res = ini.try_init()
        if res is not None:
            return k, res
    return None, None


@pytest.mark.parametrize("start", ["moving", "still"])
def test_flexible_initializer_matches_jax(start):
    """The moving start of ``test_dynamic_init.py::test_dispatches_dynamic_when_moving``
    and the still one of ``test_dispatches_static_when_still``."""
    cfg = VioConfig()
    if start == "moving":
        sc = SimConfig(duration=8.0, static_lead_in=0.0, pixel_noise=0.001, gyro_bias=GYRO_BIAS)
        kw = dict(window=12, min_parallax=0.05)
    else:
        sc = SimConfig(duration=3.0, static_lead_in=3.0, gyro_noise=0.002, acc_noise=0.02)
        kw = dict(window=10)
    data = Simulator(sc, cfg).generate()
    kj, rj = _push_all(jflex.FlexibleInitializer(cfg, **kw), data)
    kt, rt = _push_all(tflex.FlexibleInitializer(config_from_dict(dataclasses.asdict(cfg)), **kw), data)
    assert rj is not None and rt is not None
    assert (kt, rt.mode) == (kj, rj.mode) == (kj, "dynamic" if start == "moving" else "static")
    assert rt.time == rj.time
    for name in ("bg", "v", "ba", "q_wi"):
        np.testing.assert_allclose(np.asarray(getattr(rt, name)), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert np.asarray(rt.q_wi).dtype == np.float32


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_inject_init_result_matches_jax(mode):
    rng = np.random.default_rng(5)
    q = rng.normal(size=4)
    res = jflex.InitResult(q_wi=(q / np.linalg.norm(q)).astype(np.float32), v=rng.normal(size=3),
                           bg=rng.normal(0, 0.01, 3), ba=np.zeros(3), time=1.25, mode=mode)
    vs_j = jinit_vio_state(CFG)
    want = jax.tree.map(np.asarray, jflex.inject_init_result(CFG, vs_j, res))
    got = to_reference_numpy(tflex.inject_init_result(
        TCFG, from_reference(jax.tree.map(np.asarray, vs_j), "cpu"), tflex.InitResult(**vars(res))))
    fj, ft = want.filter, got["filter"]
    for name in ("q", "q_null", "v", "v_null", "bg", "ba", "p", "p_null", "time", "initialized"):
        a, b = ft[name], np.asarray(getattr(fj, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    Sj, St = np.asarray(fj.P, np.float64), ft["P"].astype(np.float64)
    np.testing.assert_allclose(St @ St.T, Sj @ Sj.T, rtol=0, atol=1e-6)


def _render(sc):
    sim = Simulator(sc, CFG)
    data = sim.generate()
    imgs = np.asarray(jrender_sequence(CFG, sim, data["t_img"])).astype(np.uint8)
    return data, imgs


@pytest.fixture(scope="module")
def moving():
    """50 frames of a moving start (no static lead-in, gyro bias)."""
    return _render(SimConfig(duration=2.5, static_lead_in=0.0, gyro_bias=GYRO_BIAS))


@pytest.fixture(scope="module")
def still_start():
    """60 frames: 1.5 s at rest, then motion."""
    return _render(SimConfig(duration=3.0, static_lead_in=1.5))


def _spy(monkeypatch, module):
    """Record the mode of every result that ``module.inject_init_result`` injects."""
    modes = []
    real = module.inject_init_result

    def spy(cfg, vs, res):
        modes.append(res.mode)
        return real(cfg, vs, res)

    monkeypatch.setattr(module, "inject_init_result", spy)
    return modes


def test_run_image_sequence_flexible_matches_jax(moving, monkeypatch):
    data, imgs = moving
    j_modes, t_modes = _spy(monkeypatch, jflex), _spy(monkeypatch, tflex)
    frames_j = jpipe.FrameInput(
        image=jnp.asarray(imgs),
        imu=JImuBatch(t=jnp.asarray(data["imu_t"]), w=jnp.asarray(data["imu_w"]),
                      a=jnp.asarray(data["imu_a"]), valid=jnp.asarray(data["imu_valid"])),
        t=jnp.asarray(data["t_img"]))
    _, oj = jpipe.run_image_sequence_flexible(CFG, jpipe.init_pipeline_state(CFG), frames_j)
    oj = jax.tree.map(np.asarray, oj)
    frames_t = tpipe.FrameInput(
        image=torch.from_numpy(imgs),
        imu=ImuBatch(t=torch.from_numpy(data["imu_t"]), w=torch.from_numpy(data["imu_w"]),
                     a=torch.from_numpy(data["imu_a"]), valid=torch.from_numpy(data["imu_valid"])),
        t=torch.from_numpy(data["t_img"]))
    _, ot = tpipe.run_image_sequence_flexible(TCFG, tpipe.init_pipeline_state(TCFG, "cpu"), frames_t)
    T = len(data["t_img"])
    assert ot.p.shape == (T, 3) and ot.initialized.shape == (T,)
    mj, mt = oj.initialized.astype(bool), ot.initialized.numpy()
    assert j_modes == t_modes == ["dynamic"]
    np.testing.assert_array_equal(mt, mj)
    assert mt.sum() >= 25 and not mt[:14].any()  # fired once the 15-frame window was full
    assert np.abs(ot.p.numpy()[mt] - oj.p[mt]).max() < 0.01
    assert ate_rmse(ot.p.numpy()[mt], data["gt_p"][mt]) < 0.1


def _frame_dicts(data, imgs, lo=0, hi=None):
    for k in range(lo, len(data["t_img"]) if hi is None else hi):
        yield dict(image=imgs[k], imu_t=data["imu_t"][k], imu_w=data["imu_w"][k],
                   imu_a=data["imu_a"][k], imu_valid=data["imu_valid"][k], t_img=data["t_img"][k])


@pytest.mark.parametrize("mode", ["static", "auto"])
def test_run_streaming_matches_jax(mode, moving, still_start, monkeypatch):
    """``static`` on the sequence that starts at rest (the on-device static
    initializer fires); ``auto`` on the moving start (the host initializer
    injects a dynamic result)."""
    data, imgs = still_start if mode == "static" else moving
    j_modes, t_modes = _spy(monkeypatch, jflex), _spy(monkeypatch, tflex)
    rj = jcli._run_streaming(CFG, _frame_dicts(data, imgs), init_mode=mode)
    rt = tcli._run_streaming(TCFG, _frame_dicts(data, imgs), device="cpu", init_mode=mode)
    tj, pj, qj, ij = rj[:4]
    tt, pt, qt, it = rt[:4]
    assert pt.shape == pj.shape == (len(data["t_img"]), 3)
    np.testing.assert_array_equal(it, ij)
    assert it.sum() >= 25
    assert j_modes == t_modes == ([] if mode == "static" else ["dynamic"])
    assert np.abs(pt[it] - pj[it]).max() < 0.01
    np.testing.assert_allclose(tt[it], tj[it], atol=1e-5)
    for key in ("tracks", "resets"):
        np.testing.assert_array_equal(rt[4][key], rj[4][key], err_msg=key)


def test_resume_equals_uninterrupted(still_start, tmp_path):
    """Checkpoint after frame 40, resume into a fresh state, run the rest:
    the stitched run equals the uninterrupted one exactly (the whole
    PipelineState, previous pyramid included, crosses the file)."""
    data, imgs = still_start
    T, k = len(data["t_img"]), 40
    full = tcli._run_streaming(TCFG, _frame_dicts(data, imgs), device="cpu", init_mode="static")
    ck = str(tmp_path / "ck")
    a = tcli._run_streaming(TCFG, _frame_dicts(data, imgs, 0, k), device="cpu", init_mode="static",
                            checkpoint=ck)
    assert a[3].any()  # initialized before the checkpoint
    b = tcli._run_streaming(TCFG, _frame_dicts(data, imgs, k, T), device="cpu", init_mode="auto",
                            resume=ck)
    for i in range(4):  # t, p, q, initialized
        np.testing.assert_array_equal(np.concatenate([a[i], b[i]]), full[i])
    for x, y in ((b[6].vio.filter.P, full[6].vio.filter.P), (b[6].tracker.ids, full[6].tracker.ids)):
        assert torch.equal(x, y)

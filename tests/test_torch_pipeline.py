"""The PyTorch port's image-to-pose slice against the JAX package.

60 rendered frames (1 s static lead-in, then motion; 240x320 camera with
scaled intrinsics, 48 feature slots, 6 clones, pure MSCKF) go through the JAX
package's jitted ``pipeline_step`` and the port's ``run_image_sequence`` from
the same initial state. Gates: both initialize on the same frame; track ids
and validity agree on >= 98% of slot-frames; max position difference < 1 cm.
Measured on this configuration (CPU): ids and validity agree on 100% of
slot-frames, both initialize on frame 9, max position difference 2.4e-6 m,
ATE 0.02435 m on both.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.pipeline as jpipe
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.evaluate import ate_rmse
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
from larvio_tpu_torch.convert import from_reference, to_reference_numpy
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step, run_image_sequence

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_slam_features=0, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60),
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs():
    sim = Simulator(SimConfig(duration=3.0, static_lead_in=1.0), CFG)
    data = sim.generate()
    imgs = jrender_sequence(CFG, sim, data["t_img"])
    T = imgs.shape[0]
    step = jax.jit(jpipe.pipeline_step, static_argnums=0)
    ps = jpipe.init_pipeline_state(CFG)
    j_ids, j_valid, j_p, j_init, states = [], [], [], [], []
    for k in range(T):
        fr = jpipe.FrameInput(
            image=jnp.asarray(imgs[k]),
            imu=JImuBatch(t=jnp.asarray(data["imu_t"][k]), w=jnp.asarray(data["imu_w"][k]),
                          a=jnp.asarray(data["imu_a"][k]), valid=jnp.asarray(data["imu_valid"][k])),
            t=jnp.asarray(data["t_img"][k]),
        )
        ps, out = step(CFG, ps, fr)
        j_ids.append(np.asarray(ps.tracker.ids))
        j_valid.append(np.asarray(ps.tracker.valid))
        j_p.append(np.asarray(out.p))
        j_init.append(bool(out.initialized))
        if k == 30:
            states.append(jax.tree.map(np.asarray, ps))
    frames = FrameInput(
        image=torch.from_numpy(np.array(imgs)),
        imu=ImuBatch(t=torch.from_numpy(data["imu_t"]), w=torch.from_numpy(data["imu_w"]),
                     a=torch.from_numpy(data["imu_a"]), valid=torch.from_numpy(data["imu_valid"])),
        t=torch.from_numpy(data["t_img"]),
    )
    return dict(data=data, frames=frames, j_ids=np.stack(j_ids), j_valid=np.stack(j_valid),
                j_p=np.stack(j_p), j_init=np.array(j_init), mid_state=states[0])


def test_slice_matches_jax_over_sequence(runs):
    ps = init_pipeline_state(CFG, "cpu")
    ids, valid, p, inited = [], [], [], []
    frames = runs["frames"]
    for k in range(frames.t.shape[0]):
        fr = FrameInput(image=frames.image[k],
                        imu=ImuBatch(t=frames.imu.t[k], w=frames.imu.w[k], a=frames.imu.a[k],
                                     valid=frames.imu.valid[k]),
                        t=frames.t[k])
        ps, out = pipeline_step(CFG, ps, fr)
        ids.append(ps.tracker.ids.numpy())
        valid.append(ps.tracker.valid.numpy())
        p.append(out.p.numpy())
        inited.append(bool(out.initialized))
    ids, valid, p, inited = np.stack(ids), np.stack(valid), np.stack(p), np.array(inited)
    assert inited.argmax() == runs["j_init"].argmax() and inited.sum() == runs["j_init"].sum()
    assert inited.sum() >= 40
    assert (ids == runs["j_ids"]).mean() >= 0.98
    assert (valid == runs["j_valid"]).mean() >= 0.98
    assert np.abs(p - runs["j_p"]).max() < 0.01
    gt = runs["data"]["gt_p"]
    assert abs(ate_rmse(p[inited], gt[inited]) - ate_rmse(runs["j_p"][inited], gt[inited])) < 0.005


def test_run_image_sequence_matches_step_loop(runs):
    """The sequence runner stacks StepOutput over the same per-frame steps."""
    frames = runs["frames"]
    short = FrameInput(image=frames.image[:12], t=frames.t[:12],
                       imu=ImuBatch(t=frames.imu.t[:12], w=frames.imu.w[:12], a=frames.imu.a[:12],
                                    valid=frames.imu.valid[:12]))
    _, outs = run_image_sequence(CFG, init_pipeline_state(CFG, "cpu"), short)
    assert outs.p.shape == (12, 3) and outs.initialized.shape == (12,)
    np.testing.assert_allclose(outs.p.numpy(), runs["j_p"][:12], atol=1e-4)


def test_pipeline_state_round_trip_exact(runs):
    ref = runs["mid_state"]
    st = from_reference(ref, "cpu")
    assert st.tracker.desc.dtype == torch.int32  # uint32 words as a bit-exact view
    back = to_reference_numpy(st)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = back
        for pth in path:
            node = node[getattr(pth, "name", getattr(pth, "idx", None))]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf), path


def test_converted_state_steps_like_jax(runs):
    """A converted mid-sequence PipelineState steps on in the port exactly as
    the JAX run does (same tracks, same pose to 1 mm)."""
    ps = from_reference(runs["mid_state"], "cpu")
    frames = runs["frames"]
    for k in range(31, 36):
        fr = FrameInput(image=frames.image[k], t=frames.t[k],
                        imu=ImuBatch(t=frames.imu.t[k], w=frames.imu.w[k], a=frames.imu.a[k],
                                     valid=frames.imu.valid[k]))
        ps, out = pipeline_step(CFG, ps, fr)
        np.testing.assert_array_equal(ps.tracker.ids.numpy(), runs["j_ids"][k])
        np.testing.assert_allclose(out.p.numpy(), runs["j_p"][k], atol=1e-3)


def test_port_imports_no_jax():
    """A process that imports larvio_tpu_torch and runs 3 CPU frames never
    loads jax or flax."""
    code = textwrap.dedent("""
        import sys
        _JAX = ("jax", "jaxlib", "flax")
        pre = {m for m in sys.modules if m.split(".")[0] in _JAX}

        class _BlockJax:  # any attempt to import JAX from here on fails loudly
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in _JAX:
                    raise ImportError("blocked import of " + name)

        sys.meta_path.insert(0, _BlockJax())
        import numpy as np, torch
        from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
        from larvio_tpu_torch.data.sim import SimConfig, Simulator
        from larvio_tpu_torch.data.render import render_sequence
        from larvio_tpu_torch.models.propagation import ImuBatch
        from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step
        torch.set_num_threads(1)
        s = 160 / 752
        cfg = VioConfig(
            camera=CameraConfig(width=160, height=120,
                                intrinsics=tuple(v * s for v in (458.654, 457.296, 367.215, 248.375))),
            frontend=FrontendConfig(max_features=24, grid_rows=2, grid_cols=2, pyramid_levels=2),
            filter=FilterConfig(max_slam_features=0, max_clones=4, imu_slots_per_frame=14))
        sim = Simulator(SimConfig(duration=0.15), cfg)
        d = sim.generate()
        imgs = render_sequence(cfg, sim, d["t_img"], device="cpu")
        ps = init_pipeline_state(cfg, "cpu")
        for k in range(3):
            imu = ImuBatch(t=torch.from_numpy(d["imu_t"][k]), w=torch.from_numpy(d["imu_w"][k]),
                           a=torch.from_numpy(d["imu_a"][k]), valid=torch.from_numpy(d["imu_valid"][k]))
            ps, out = pipeline_step(cfg, ps, FrameInput(image=imgs[k], imu=imu, t=torch.tensor(d["t_img"][k])))
        assert torch.isfinite(out.p).all()
        new = {m for m in sys.modules if m.split(".")[0] in _JAX} - pre
        assert not pre and not new, (pre, new)
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PALLAS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stdout + proc.stderr

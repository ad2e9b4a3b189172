"""The PyTorch port's Renderer against the JAX package's on the same poses.

Tolerance: 99% of pixels within 1e-3 gray levels and every pixel within
5e-3. Measured (240x320, three poses, CPU): max 1.7e-3, about 0.13% of pixels
above 1e-3, none above 1e-2. The floor is f32 rounding, not the blob
scatter-add order: the per-pixel ray rotation (a 3x3 matmul that XLA and
PyTorch round differently) moves the plane hit point by ~1e-4 texel after
the 1/0.15 m texel scale, times texture gradients of ~15 gray levels per
texel; the camera rays themselves agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.config import CameraConfig, VioConfig
from larvio_tpu.data.render import Renderer as JRenderer
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu_torch.data.render import Renderer, render_sequence

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(camera=CameraConfig(width=320, height=240,
                                    intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))))


@pytest.fixture(scope="module")
def sim():
    return Simulator(SimConfig(duration=8.0), CFG)


def _assert_images_close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    d = np.abs(got - ref)
    assert np.quantile(d, 0.99) <= 1e-3, np.quantile(d, 0.99)
    assert d.max() <= 5e-3, d.max()


@pytest.mark.parametrize("t", [0.5, 3.2, 6.05])
def test_render_matches_jax(sim, t):
    p_w, R_wi = sim.pose(np.asarray(t))
    R_ci = np.asarray(sim.R_ci)
    R_wc_T = (R_ci @ R_wi).T
    p_cam = p_w + R_wi.T @ (-R_ci.T @ np.asarray(sim.t_ci))
    ref = np.asarray(JRenderer(CFG, np.asarray(sim.landmarks)).render(
        jnp.asarray(R_wc_T, jnp.float32), jnp.asarray(p_cam, jnp.float32)))
    got = Renderer(CFG, np.asarray(sim.landmarks), device="cpu")(
        torch.as_tensor(R_wc_T, dtype=torch.float32), torch.as_tensor(p_cam, dtype=torch.float32)).numpy()
    _assert_images_close(got, ref)


def test_render_sequence_matches_jax(sim):
    t_img = np.asarray([0.05, 2.5, 4.0], np.float32)
    ref = jrender_sequence(CFG, sim, t_img)
    got = render_sequence(CFG, sim, t_img, device="cpu").numpy()
    _assert_images_close(got, ref)


def test_renderer_is_a_module_with_buffers(sim):
    rend = Renderer(CFG, np.asarray(sim.landmarks), device="cpu")
    names = {n for n, _ in rend.named_buffers()}
    assert {"texture", "rays_cam", "landmarks", "amps", "offs"} <= names
    assert rend.rays_cam.shape == (CFG.camera.height * CFG.camera.width, 3)

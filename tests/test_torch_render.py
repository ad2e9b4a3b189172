"""The PyTorch port's Renderer against the JAX package's on the same poses,
and its blob scatter's fixed order: each pixel's stamps added in the JAX
scatter's update order (landmark, then stamp offset), on every device, so a
frame's bits repeat from render to render and from process to process.

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
from larvio_tpu_torch.data.render import Renderer, add_in_order, render_sequence

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


def _pose(sim, t):
    p_w, R_wi = sim.pose(np.asarray(t))
    R_ci = np.asarray(sim.R_ci)
    return (R_ci @ R_wi).T, p_w + R_wi.T @ (-R_ci.T @ np.asarray(sim.t_ci))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("t", [0.5, 3.2, 6.05])
def test_render_matches_jax(sim, t):
    R_wc_T, p_cam = _pose(sim, t)
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


def test_blob_sum_follows_the_update_order(sim):
    """On a frame where 5 stamps overlap one pixel, ``add_in_order`` equals
    the CPU's sequential ``index_add`` bit for bit, and the same terms in
    reversed landmark order give other bits (the case sees an order change)."""
    rend = Renderer(CFG, np.asarray(sim.landmarks), device="cpu")
    R_wc_T, p_cam = (torch.as_tensor(x, dtype=torch.float32) for x in _pose(sim, 3.2))
    bg = rend.background(R_wc_T, p_cam)
    flat, vals = rend.blobs(R_wc_T, p_cam)
    assert int(torch.bincount(flat[vals != 0]).max()) >= 3
    sequential = bg.index_add(0, flat.reshape(-1), vals.reshape(-1))
    got = add_in_order(bg, flat.reshape(-1), vals.reshape(-1))
    np.testing.assert_array_equal(_bits(got), _bits(sequential))
    reversed_ = add_in_order(bg, flat.flip(0).reshape(-1), vals.flip(0).reshape(-1))
    assert (_bits(reversed_) != _bits(sequential)).any()


def test_render_sequence_repeats_on_cpu(sim):
    t_img = np.asarray([0.05, 3.2, 6.05], np.float32)
    np.testing.assert_array_equal(_bits(render_sequence(CFG, sim, t_img, device="cpu")),
                                  _bits(render_sequence(CFG, sim, t_img, device="cpu")))

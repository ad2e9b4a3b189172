"""The port's distance from the JAX package's trajectory at full EuRoC
width (752x480, the default ``VioConfig()``: 200 feature slots, 20 clones,
6 SLAM slots), on the CPU.

The whole clean 8 s simulator workload (``chip_smoke.py``'s main path: 160
frames, 2 s at rest, so the static initializer fires at about frame 20 and
the last 120 frames move), rendered once by the JAX package, goes through
the JAX package's jitted ``pipeline_step`` and the port's
``run_image_sequence``. A window that ends inside the rest compares
positions that barely move, so the test runs the whole sequence. Gates: the
initialized masks are equal and positions within 1 cm, the bar the 320x240
parity tests use (``tests/test_torch_pipeline.py``). The test prints the
largest position difference.

Marked slow: about a minute and a bit over 1 GiB of host memory, more than
the fast tier's budget for one test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.pipeline as jpipe
from larvio_tpu.config import VioConfig
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
from larvio_tpu_torch.convert import config_from_dict
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, run_image_sequence

N_FRAMES = 160
POS_TOL = 0.01  # m


@pytest.mark.slow
def test_full_width_trajectory_matches_jax():
    jcfg = VioConfig()
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    sim = Simulator(SimConfig(duration=8.0), jcfg)
    data = {k: v[:N_FRAMES] for k, v in sim.generate().items()}
    imgs = np.asarray(jrender_sequence(jcfg, sim, data["t_img"]))
    assert imgs.shape == (N_FRAMES, 480, 752)

    step = jax.jit(jpipe.pipeline_step, static_argnums=0)
    ps = jpipe.init_pipeline_state(jcfg)
    j_p, j_init = [], []
    for k in range(N_FRAMES):
        fr = jpipe.FrameInput(
            image=jnp.asarray(imgs[k]),
            imu=JImuBatch(t=jnp.asarray(data["imu_t"][k]), w=jnp.asarray(data["imu_w"][k]),
                          a=jnp.asarray(data["imu_a"][k]), valid=jnp.asarray(data["imu_valid"][k])),
            t=jnp.asarray(data["t_img"][k]),
        )
        ps, out = step(jcfg, ps, fr)
        j_p.append(np.asarray(out.p))
        j_init.append(bool(out.initialized))
    j_p, j_init = np.stack(j_p), np.array(j_init)

    torch.set_num_threads(1)
    frames = FrameInput(
        image=torch.from_numpy(imgs),
        imu=ImuBatch(t=torch.from_numpy(data["imu_t"]), w=torch.from_numpy(data["imu_w"]),
                     a=torch.from_numpy(data["imu_a"]), valid=torch.from_numpy(data["imu_valid"])),
        t=torch.from_numpy(data["t_img"]),
    )
    _, outs = run_image_sequence(tcfg, init_pipeline_state(tcfg, "cpu"), frames)
    t_p, t_init = outs.p.numpy(), outs.initialized.numpy()

    np.testing.assert_array_equal(t_init, j_init)
    assert t_init.sum() >= 100
    d = float(np.abs(t_p - j_p).max())
    print(f"752x480, {N_FRAMES} frames, {int(t_init.sum())} initialized: max |dp| {d:.3e} m "
          f"from the JAX package (gate {POS_TOL})")
    assert d < POS_TOL

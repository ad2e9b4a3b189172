"""The cache of captured steps (``larvio_tpu_torch/core/graph.py::CACHE``):
the port's counterpart of ``jax.jit``'s compile-once cache, and the jitted
entry points that go through it (``pipeline.jit_pipeline_step``,
``api.step``, ``parallel/fleet.py::jit_fleet_step``).

On the CPU (here): the cache key separates the entry's static arguments
(config values), shapes, dtypes, tree structure and device, and is equal
for equal signatures; nothing is cached, and each entry point equals its
eager step bit for bit; each equals the JAX package's jitted counterpart on
the same seeded numpy inputs: ``jit_pipeline_step`` at
``tests/test_torch_pipeline.py::test_converted_state_steps_like_jax``'s
tolerance (track ids equal, positions within 1e-3 m), ``api.step`` and
``jit_fleet_step`` at the fleet tests' (``initialized`` and ``did_reset``
equal, positions within 1e-3 m). The JAX side runs as its own tests run it
(its jitted functions on the CPU, the plain LK there).

The ``cuda`` cases need the card and skip here; there they hold: two runs of
one signature make one capture and equal bits; a new config or fleet width
makes a new capture; the caller's state is not modified; a returned tensor
is not overwritten by the next call; per-frame calls equal the captured
sequence. They import no JAX:

    python -m pytest --noconftest tests/test_torch_jit_cache.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from larvio_tpu_torch import api as tapi
from larvio_tpu_torch import config as tconfig
from larvio_tpu_torch.convert import config_from_dict
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.graph import CACHE, signature
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data.render import render_sequence
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.models.msckf import filter_step, init_vio_state
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.parallel.fleet import fleet_step, init_fleet_state, jit_fleet_step
from larvio_tpu_torch.pipeline import (FrameInput, init_pipeline_state, jit_pipeline_step, pipeline_step,
                                       run_image_sequence)

torch.set_num_threads(1)

_S = 160 / 752


def _cfg(mod):
    """tests/test_torch_fleet.py's image configuration (pure MSCKF, 160x120)
    from either package's config module."""
    return mod.VioConfig(
        camera=mod.CameraConfig(width=160, height=120,
                                intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
        frontend=mod.FrontendConfig(max_features=24, grid_rows=2, grid_cols=2, pyramid_levels=2),
        filter=mod.FilterConfig(max_slam_features=0, max_clones=5, imu_slots_per_frame=14, static_init_samples=60),
    )


CFG = _cfg(tconfig)
B = 3


def _assert_bits(a, b, what=""):
    """Every leaf of a and b has the same dtype, shape and bits (NaN included)."""
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} leaf {i}"
        xb = x.contiguous().reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x
        yb = y.contiguous().reshape(-1).view(torch.uint8) if y.dtype != torch.bool else y
        assert torch.equal(xb, yb), f"{what} leaf {i} {tuple(x.shape)} differs"


def _image_data(duration=2.0):
    sim = Simulator(SimConfig(duration=duration, static_lead_in=1.0), CFG)
    data = sim.generate()
    return data, render_sequence(CFG, sim, data["t_img"], device="cpu").numpy()


def _frame(data, imgs, k, device="cpu") -> FrameInput:
    g = lambda key: torch.as_tensor(data[key][k], device=device)  # noqa: E731
    return FrameInput(image=torch.as_tensor(imgs[k], device=device), t=g("t_img"),
                      imu=ImuBatch(t=g("imu_t"), w=g("imu_w"), a=g("imu_a"), valid=g("imu_valid")))


def _feature_lanes(duration=3.0):
    """B seeded feature-level sequences, stacked (T, B, ...)."""
    lanes = [Simulator(SimConfig(duration=duration, pixel_noise=0.001, seed=s), CFG).generate()
             for s in range(B)]
    return {k: np.stack([d[k] for d in lanes], axis=1) for k in lanes[0]}


# --------------------------------------------------------------------------
# the key (CPU)
# --------------------------------------------------------------------------


def _args(cfg=CFG, n=24, dtype=torch.float32, device="cpu"):
    state = {"x": torch.zeros(n, dtype=dtype, device=device), "k": torch.zeros(3, dtype=torch.int32, device=device)}
    return ("filter_step", cfg), (state, (torch.zeros(2, device=device), torch.zeros(2, device=device)))


@pytest.mark.parametrize("change", ["config", "entry", "shape", "dtype", "structure", "device"])
def test_signature_separates(change):
    entry, tree = _args()
    if change == "config":
        entry2, tree2 = _args(cfg=dataclasses.replace(CFG, filter=dataclasses.replace(CFG.filter, max_clones=6)))
    elif change == "entry":
        entry2, tree2 = ("pipeline_step", CFG), tree
    elif change == "shape":
        entry2, tree2 = _args(n=25)
    elif change == "dtype":
        entry2, tree2 = _args(dtype=torch.float64)
    elif change == "structure":  # the same leaves in a list, not a tuple
        entry2, tree2 = entry, (tree[0], list(tree[1]))
    else:
        entry2, tree2 = _args(device="meta")
    assert signature(entry, tree) != signature(entry2, tree2)


def test_signature_equal_for_equal_signatures():
    """New tensors of the same shapes and dtypes, and a config rebuilt from
    its dict, give the same key (and so the same captured step)."""
    entry, tree = _args()
    entry2, tree2 = _args(cfg=config_from_dict(dataclasses.asdict(CFG)))
    tree2 = tree_map(lambda a: a + 1, tree2)
    assert signature(entry, tree) == signature(entry2, tree2)
    assert hash(signature(entry, tree)) == hash(signature(entry2, tree2))


# --------------------------------------------------------------------------
# the entry points on the CPU: the eager step, nothing cached
# --------------------------------------------------------------------------


def test_entry_points_equal_the_eager_step_on_cpu():
    data, imgs = _image_data(1.2)
    ps, ref = init_pipeline_state(CFG, "cpu"), init_pipeline_state(CFG, "cpu")
    fleet = _feature_lanes(1.2)
    vs, vref = init_vio_state(CFG, "cpu"), init_vio_state(CFG, "cpu")
    fs, fref = init_fleet_state(CFG, B, "cpu"), init_fleet_state(CFG, B, "cpu")
    captures, n = CACHE.captures, len(CACHE)
    for k in range(len(data["t_img"])):
        fr = _frame(data, imgs, k)
        ps, out = jit_pipeline_step(CFG, ps, fr)
        ref, out_ref = pipeline_step(CFG, ref, fr)
        _assert_bits((ps, out), (ref, out_ref), f"jit_pipeline_step, frame {k}")
        x = tapi.make_frame_inputs(data, k, device="cpu")
        vs, out = tapi.step(CFG, vs, *x)
        vref, out_ref = filter_step(CFG, vref, *x)
        _assert_bits((vs, out), (vref, out_ref), f"api.step, frame {k}")
        x = tapi.make_frame_inputs(fleet, k, device="cpu")
        fs, out = jit_fleet_step(CFG, fs, *x)
        fref, out_ref = fleet_step(CFG, fref, *x)
        _assert_bits((fs, out), (fref, out_ref), f"jit_fleet_step, frame {k}")
    assert bool(ref.vio.filter.initialized) and bool(vref.filter.initialized)
    assert CACHE.captures == captures and len(CACHE) == n  # no cache on the CPU


# --------------------------------------------------------------------------
# against the JAX package's jitted entry points (CPU)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's configuration, equal to ``CFG`` field for field
    (JAX is imported only here: the card's cases import none)."""
    import larvio_tpu.config as jconfig

    jcfg = _cfg(jconfig)
    assert config_from_dict(dataclasses.asdict(jcfg)) == CFG
    return jcfg


def test_jit_pipeline_step_matches_jax(jax_side):
    import jax.numpy as jnp

    import larvio_tpu.pipeline as jpipe
    from larvio_tpu.models.propagation import ImuBatch as JImuBatch

    data, imgs = _image_data(2.0)
    jps, tps = jpipe.init_pipeline_state(jax_side), init_pipeline_state(CFG, "cpu")
    n_init = 0
    for k in range(len(data["t_img"])):
        jfr = jpipe.FrameInput(image=jnp.asarray(imgs[k]), t=jnp.asarray(data["t_img"][k]),
                               imu=JImuBatch(t=jnp.asarray(data["imu_t"][k]), w=jnp.asarray(data["imu_w"][k]),
                                             a=jnp.asarray(data["imu_a"][k]),
                                             valid=jnp.asarray(data["imu_valid"][k])))
        jps, jout = jpipe.jit_pipeline_step(jax_side, jps, jfr)
        tps, tout = jit_pipeline_step(CFG, tps, _frame(data, imgs, k))
        np.testing.assert_array_equal(tps.tracker.ids.numpy(), np.asarray(jps.tracker.ids), err_msg=f"frame {k}")
        assert bool(tout.initialized) == bool(jout.initialized), f"frame {k}"
        np.testing.assert_allclose(tout.p.numpy(), np.asarray(jout.p), atol=1e-3, err_msg=f"frame {k}")
        n_init += bool(tout.initialized)
    assert n_init >= 20


@pytest.mark.parametrize("entry", ["api.step", "jit_fleet_step"])
def test_filter_entry_points_match_jax(jax_side, entry):
    import jax

    from larvio_tpu import api as japi
    from larvio_tpu.models.msckf import init_vio_state as jinit_vio_state
    from larvio_tpu.parallel import fleet as jfleet

    if entry == "api.step":
        data = Simulator(SimConfig(duration=3.0, pixel_noise=0.001), CFG).generate()
        js, ts = jinit_vio_state(jax_side), init_vio_state(CFG, "cpu")
        jstep, tstep = japi.step, tapi.step
    else:
        data = _feature_lanes(3.0)
        js, ts = jfleet.init_fleet_state(jax_side, B), init_fleet_state(CFG, B, "cpu")
        jstep, tstep = jfleet.jit_fleet_step, jit_fleet_step
    T = data["t_img"].shape[0]
    for k in range(T):
        js, jout = jstep(jax_side, js, *japi.make_frame_inputs(data, k))
        ts, tout = tstep(CFG, ts, *tapi.make_frame_inputs(data, k, device="cpu"))
        jout = jax.tree.map(np.asarray, jout)
        np.testing.assert_array_equal(tout.initialized.numpy(), jout.initialized, err_msg=f"frame {k}")
        np.testing.assert_array_equal(tout.did_reset.numpy(), jout.did_reset, err_msg=f"frame {k}")
        np.testing.assert_allclose(tout.p.numpy(), jout.p, atol=1e-3, err_msg=f"frame {k}")
    assert np.asarray(jout.initialized).all() and not np.asarray(jout.did_reset).any()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    card_numerics()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(dev):
    data, imgs = _image_data(2.0)
    T = len(data["t_img"])
    frames = [_frame(data, imgs, k, dev) for k in range(T)]
    return data, tree_map(lambda *a: torch.stack(a), *frames)


@pytest.mark.cuda
def test_one_signature_captures_once_on_card(dev, card_frames):
    """Two ``run_image_sequence`` calls and the per-frame ``jit_pipeline_step``
    calls of one signature make one capture and give equal bits."""
    _, frames = card_frames
    CACHE.clear()
    n = CACHE.captures
    ps = init_pipeline_state(CFG, dev)
    a = run_image_sequence(CFG, ps, frames)
    b = run_image_sequence(CFG, ps, frames)
    assert CACHE.captures == n + 1 and len(CACHE) == 1
    n += 1
    st, outs = ps, []
    for k in range(frames.t.shape[0]):
        st, out = jit_pipeline_step(CFG, st, tree_map(lambda x: x[k], frames))
        outs.append(out)
    assert CACHE.captures == n and len(CACHE) == 1
    _assert_bits(a, b, "second run")
    _assert_bits((st, tree_map(lambda *o: torch.stack(o), *outs)), a, "per-frame calls")


@pytest.mark.cuda
def test_new_config_or_width_captures_anew_on_card(dev, card_frames):
    _, frames = card_frames
    CACHE.clear()
    n = CACHE.captures
    one = tree_map(lambda x: x[0], frames)
    jit_pipeline_step(CFG, init_pipeline_state(CFG, dev), one)
    other = dataclasses.replace(CFG, filter=dataclasses.replace(CFG.filter, max_clones=6))
    jit_pipeline_step(other, init_pipeline_state(other, dev), one)
    assert len(CACHE) == 2
    data = _feature_lanes(1.0)
    for width in (B, B - 1, B):
        x = tree_map(lambda a: a[:width].contiguous(), tapi.make_frame_inputs(data, 0, device=dev))
        jit_fleet_step(CFG, init_fleet_state(CFG, width, dev), *x)
    assert len(CACHE) == 4 and CACHE.captures == n + 4


@pytest.mark.cuda
def test_caller_state_kept_and_outputs_not_overwritten_on_card(dev, card_frames):
    _, frames = card_frames
    ps = init_pipeline_state(CFG, dev)
    for k in range(10):
        ps, _ = jit_pipeline_step(CFG, ps, tree_map(lambda x: x[k], frames))
    before = tree_map(torch.clone, ps)
    s1, o1 = jit_pipeline_step(CFG, ps, tree_map(lambda x: x[10], frames))
    keep = tree_map(torch.clone, (s1, o1))
    s2, o2 = jit_pipeline_step(CFG, s1, tree_map(lambda x: x[11], frames))
    _assert_bits(ps, before, "the caller's state")
    _assert_bits((s1, o1), keep, "the first call's results after the next call")
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(leaves(o1), leaves(o2)))

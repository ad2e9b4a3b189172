"""Kernels and main path of the PyTorch port on an NVIDIA GPU.

These tests need the card and skip without it. They import no JAX (the
machine with the card has none), so they run there without the suite's
conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

K1 and K3 (batched LK, one lane per instance) are held to the JAX
package's LK kernel gate against their plain version (>= 95% valid
agreement, >= 95% of both-valid points within 0.1 px); each K3 lane equals
K1 on the same inputs within 1e-4 px with identical validity; a ragged
table (45 slots, not a multiple of the warps per block) equals the first 45
slots of the full one. The fused describe kernel, single and batched, is
held to ``chip_smoke._describe_gate`` against the plain ``describe`` on the
card: >= 97% of the valid finite slots bit-identical, >= 99.9% of their bits
equal, none more than 8 bits apart (the blur is bit-exact; the moments are
summed in another order than ``torch.sum``, so a rotated sample may round
the other way); invalid slots are 0; each batched lane equals its one-lane
launch bit for bit. The sharded fleet's dry run runs with two ``gloo`` ranks
sharing the card.
"""

import numpy as np
import pytest
import torch

from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.data.render import render_sequence
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops import orb
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.image import build_pyramid
from larvio_tpu_torch.ops.lk import lk_track, make_grad_pyramid
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state, run_fleet_image_sequence
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step

pytestmark = pytest.mark.cuda

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_slam_features=0, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60),
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seq(dev):
    sim = Simulator(SimConfig(duration=3.0, static_lead_in=1.0), CFG)
    data = sim.generate()
    return data, render_sequence(CFG, sim, data["t_img"], device=dev)


def test_lk_kernel_matches_plain(dev, seq):
    _, imgs = seq
    img0, img1 = imgs[40], imgs[41]
    scores, xy = grid_topk(nms(shi_tomasi_response(img0), 7), 4, 5, 4, border=20)
    order = torch.argsort(-scores.reshape(-1), stable=True)
    keep = order[scores.reshape(-1)[order] > 15.0][:40]
    n = keep.shape[0]
    assert n >= 30
    pos = torch.zeros((48, 2), device=dev)
    pos[:n] = xy.reshape(-1, 2)[keep]
    valid = torch.arange(48, device=dev) < n
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    launches = lk_track_cuda.launches
    got = lk_track_cuda(p0, p1, tuple(x[0] for x in g), tuple(x[1] for x in g), pos, pos, valid)
    ref = lk_track(p0, p1, g, pos, pos, valid)
    torch.cuda.synchronize()
    assert lk_track_cuda.launches == launches + 1
    ok_g, ok_r = got.valid.cpu().numpy(), ref.valid.cpu().numpy()
    assert not ok_g[n:].any()
    assert (ok_g[:n] == ok_r[:n]).mean() >= 0.95
    both = ok_g & ok_r
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(got.pos.cpu().numpy()[both] - ref.pos.cpu().numpy()[both], axis=1)
    assert (d < 0.1).mean() >= 0.95
    none = lk_track_cuda(p0, p1, tuple(x[0] for x in g), tuple(x[1] for x in g), pos, pos,
                         torch.zeros_like(valid))
    assert not none.valid.any().item() and torch.isfinite(none.pos).all().item()


def _lk_parity(ref, got, valid, n):
    ok_g, ok_r = got.valid.cpu().numpy(), ref.valid.cpu().numpy()
    assert not ok_g[n:].any()
    assert (ok_g[:n] == ok_r[:n]).mean() >= 0.95
    both = ok_g & ok_r
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(got.pos.cpu().numpy()[both] - ref.pos.cpu().numpy()[both], axis=1)
    assert (d < 0.1).mean() >= 0.95


def test_k3_kernel_matches_plain_and_k1(dev, seq):
    """3 lanes, each its own frame pair: K3 against the batched plain version
    per lane, and each lane against K1 on that lane's inputs."""
    _, imgs = seq
    B, F = 3, 48
    img0 = torch.stack([imgs[40 + 3 * b] for b in range(B)])
    img1 = torch.stack([imgs[41 + 3 * b] for b in range(B)])
    pos = torch.zeros((B, F, 2), device=dev)
    valid = torch.zeros((B, F), dtype=torch.bool, device=dev)
    n = []
    for b in range(B):
        scores, xy = grid_topk(nms(shi_tomasi_response(img0[b]), 7), 4, 5, 4, border=20)
        order = torch.argsort(-scores.reshape(-1), stable=True)
        keep = order[scores.reshape(-1)[order] > 15.0][:40]
        n.append(keep.shape[0])
        assert n[-1] >= 30
        pos[b, : n[-1]] = xy.reshape(-1, 2)[keep]
        valid[b, : n[-1]] = True
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    gx, gy = tuple(x[0] for x in g), tuple(x[1] for x in g)
    k1, k3 = lk_track_cuda.launches, lk_track_cuda.launches_batched
    got = lk_track_cuda(p0, p1, gx, gy, pos, pos, valid)
    ref = lk_track(p0, p1, g, pos, pos, valid)
    torch.cuda.synchronize()
    assert lk_track_cuda.launches_batched == k3 + 1 and lk_track_cuda.launches == k1
    for b in range(B):
        lane = lambda r: type(r)(pos=r.pos[b], valid=r.valid[b], err=r.err[b])  # noqa: E731
        _lk_parity(lane(ref), lane(got), valid[b], n[b])
        one = lk_track_cuda(*(tuple(x[b].contiguous() for x in pyr) for pyr in (p0, p1, gx, gy)),
                            pos[b], pos[b], valid[b])
        assert torch.equal(one.valid, got.valid[b])
        assert (one.pos - got.pos[b]).abs().max().item() < 1e-4
    none = lk_track_cuda(p0, p1, gx, gy, pos, pos, torch.zeros_like(valid))
    assert not none.valid.any().item() and torch.isfinite(none.pos).all().item()


@pytest.mark.parametrize("lanes", [1, 3])
def test_lk_kernel_ragged_table(dev, seq, lanes):
    """F = 45 slots: the last block's warps past slot 44 exit; every slot equals
    the same slot of the 48-slot launch, on 1 lane (K1) and 3 lanes (K3)."""
    _, imgs = seq
    img0 = torch.stack([imgs[40 + 3 * b] for b in range(lanes)])
    img1 = torch.stack([imgs[41 + 3 * b] for b in range(lanes)])
    pos = torch.zeros((lanes, 48, 2), device=dev)
    valid = torch.zeros((lanes, 48), dtype=torch.bool, device=dev)
    for b in range(lanes):
        scores, xy = grid_topk(nms(shi_tomasi_response(img0[b]), 7), 4, 5, 4, border=20)
        order = torch.argsort(-scores.reshape(-1), stable=True)
        keep = order[scores.reshape(-1)[order] > 15.0][:46]
        pos[b, : keep.shape[0]] = xy.reshape(-1, 2)[keep]
        valid[b, : keep.shape[0]] = True
    if lanes == 1:
        img0, img1, pos, valid = img0[0], img1[0], pos[0], valid[0]
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    gx, gy = tuple(x[0] for x in g), tuple(x[1] for x in g)
    full = lk_track_cuda(p0, p1, gx, gy, pos, pos, valid)
    part = lk_track_cuda(p0, p1, gx, gy, pos[..., :45, :].contiguous(), pos[..., :45, :].contiguous(),
                         valid[..., :45].contiguous())
    torch.cuda.synchronize()
    assert part.pos.shape == (*pos.shape[:-2], 45, 2)
    assert torch.equal(part.pos, full.pos[..., :45, :]) and torch.equal(part.valid, full.valid[..., :45])
    assert part.valid.sum().item() >= 30 * (1 if lanes == 1 else lanes)


def _describe_problem(rng, lead, H, W, F):
    """Random image(s), the slab tests' edge/clamp/NaN/inf positions in the
    first 11 slots, a tenth of the slots invalid (the first 11 valid)."""
    img = rng.uniform(0, 255, (*lead, H, W)).astype(np.float32)
    p = rng.uniform([0, 0], [W - 1, H - 1], (*lead, F, 2)).astype(np.float32)
    r = orb._r
    p[..., :11, :] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1], [W - r - 1.4, H / 2],
                      [W / 2, H - r - 1.4], [r + 0.49, r + 0.51], [W - 20.5, H - 20.5],
                      [np.nan, np.nan], [1e9, -1e9], [np.inf, -np.inf]]
    valid = rng.uniform(size=(*lead, F)) >= 0.1
    valid[..., :11] = True
    return img, p, valid


@pytest.mark.parametrize("size", [(480, 752, 200), (50, 120, 16)])
def test_batched_describe_kernel_matches_plain(dev, size):
    import chip_smoke

    H, W, F = size
    B = 3
    img, p, v = _describe_problem(np.random.default_rng(1), (B,), H, W, F)
    img, pos, valid = (torch.as_tensor(a, device=dev) for a in (img, p, v))
    launches = orb.describe.launches_batched
    got = orb.describe(img, pos, valid)
    torch.cuda.synchronize()
    assert orb.describe.launches_batched == launches + 1
    assert got.shape == (B, F, 8) and not got[~valid].any().item()
    ref = orb._describe_plain(img, pos, valid)
    for b in range(B):
        chip_smoke._describe_gate(got[b], ref[b], valid[b] & torch.isfinite(pos[b]).all(dim=-1))
        assert torch.equal(got[b], orb.describe(img[b].contiguous(), pos[b].contiguous(),
                                                valid[b].contiguous()))


@pytest.mark.parametrize("size", [(480, 752, 200), (50, 120, 16)])
def test_describe_kernel_matches_plain(dev, size):
    import chip_smoke

    H, W, F = size
    img, p, v = _describe_problem(np.random.default_rng(0), (), H, W, F)
    img, pos, valid = (torch.as_tensor(a, device=dev) for a in (img, p, v))
    launches = orb.describe.launches
    got = orb.describe(img, pos, valid)
    torch.cuda.synchronize()
    assert orb.describe.launches == launches + 1
    assert got.shape == (F, 8) and got.dtype == torch.int32 and not got[~valid].any().item()
    chip_smoke._describe_gate(got, orb._describe_plain(img, pos, valid),
                              valid & torch.isfinite(pos).all(dim=-1))


def test_wrappers_reject_bad_inputs(dev):
    img = torch.zeros((64, 64), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        orb.describe(img, torch.zeros((4, 2), device=dev), torch.ones(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # valid must be bool
        orb.describe(img.float(), torch.zeros((4, 2), device=dev), torch.ones(4, device=dev))
    p = [torch.zeros((64, 64), device=dev)]
    with pytest.raises(ValueError):
        lk_track_cuda(p, p, p, p, torch.zeros((4, 2), device=dev), torch.zeros((4, 2), device=dev),
                      torch.ones(4, device=dev))  # valid must be bool


def test_fleet_path_on_card_launches_batched_kernels(dev, seq):
    """Two lanes (the second with seeded image noise) through the fleet step:
    one K3 and one batched describe launch per frame, no one-lane launch."""
    data, imgs = seq
    B, T = 2, imgs.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    bimgs = torch.stack([imgs, imgs + 2.0 * torch.randn(imgs.shape, generator=gen, device=dev)], dim=1)
    lanes = lambda k: torch.as_tensor(np.ascontiguousarray(  # noqa: E731
        np.broadcast_to(data[k][:, None], (T, B, *data[k].shape[1:]))), device=dev)
    frames = FrameInput(image=bimgs, t=lanes("t_img"),
                        imu=ImuBatch(t=lanes("imu_t"), w=lanes("imu_w"), a=lanes("imu_a"), valid=lanes("imu_valid")))
    counts = (lk_track_cuda.launches, lk_track_cuda.launches_batched,
              orb.describe.launches, orb.describe.launches_batched)
    _, outs = run_fleet_image_sequence(CFG, init_fleet_pipeline_state(CFG, B, dev), frames)
    torch.cuda.synchronize()
    assert (lk_track_cuda.launches, lk_track_cuda.launches_batched, orb.describe.launches,
            orb.describe.launches_batched) == (counts[0], counts[1] + T, counts[2], counts[3] + T)
    assert outs.p.shape == (T, B, 3) and torch.isfinite(outs.p).all().item()
    assert (outs.initialized.sum(0) >= 40).all().item() and int(outs.did_reset.sum()) == 0


def test_main_path_on_card_launches_both_kernels(dev, seq):
    data, imgs = seq
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    ps = init_pipeline_state(CFG, dev)
    lk0, orb0 = lk_track_cuda.launches, orb.describe.launches
    outs = []
    for k in range(imgs.shape[0]):
        fr = FrameInput(image=imgs[k], t=g["t_img"][k],
                        imu=ImuBatch(t=g["imu_t"][k], w=g["imu_w"][k], a=g["imu_a"][k], valid=g["imu_valid"][k]))
        ps, out = pipeline_step(CFG, ps, fr)
        outs.append(out)
    torch.cuda.synchronize()
    T = imgs.shape[0]
    assert lk_track_cuda.launches - lk0 == T and orb.describe.launches - orb0 == T
    p = torch.stack([o.p for o in outs]).cpu().numpy()
    inited = torch.stack([o.initialized for o in outs]).cpu().numpy()
    assert np.isfinite(p).all() and inited.sum() >= 40
    assert int(torch.stack([o.did_reset for o in outs]).sum()) == 0


def test_sharded_dryrun_on_card_with_gloo(dev):
    """The sharded fleet's dry run with two gloo ranks sharing the card (nccl
    needs a card per rank): its gates hold, every rank on a card."""
    from larvio_tpu_torch.parallel import multichip

    res = multichip.dryrun_multichip(2, device="cuda", backend="gloo")
    assert res["backend"] == "gloo" and all(d.startswith("cuda:") for d in res["devices"])
    assert res["slam_engaged"] >= 1 and res["p"].shape[1] == 4

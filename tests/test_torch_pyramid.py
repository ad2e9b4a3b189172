"""The front end's pyramid and gradient pyramid, ``ops/pyramid_cuda.py``, on the CPU.

On the CPU ``build_pyramid`` and ``grad_pyramid`` are the plain chain
(``ops/image.py::build_pyramid``, ``ops/lk.py::make_grad_pyramid``) and
return its tensors bit for bit, with no lane axis and with 3 lanes.

The kernels (``csrc/pyramid.cu``) run only on the card
(``tests/test_torch_cuda.py`` holds them to the plain chain there). Their
schedule is emulated here in numpy, block by block and tap by tap as the
kernels run it, with the tile sizes read from the source: ``pyr_down_kernel``'s
clamped tile load, its row pass at the even rows only (even and odd columns
kept apart), its column pass at the even columns only, the ceil sizes;
``scharr_kernel``'s grid over the tiles of every level, its clamped tile
load and each thread's column of ``SC_RUN`` rows under a sliding 3 x 3
window. Every level and every gradient image must equal the plain chain's
bits at both benchmark shapes (752x480, 640x480) and at odd sizes that
exercise the ceil rule and the edge clamps (751x479, 97x61, and 5x7, whose
levels lie inside one tile and shrink to a pixel), for one image and for 3
lanes, each lane equal to its own one-image run.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from larvio_tpu_torch.ops import image as plain
from larvio_tpu_torch.ops.lk import make_grad_pyramid
from larvio_tpu_torch.ops.pyramid_cuda import build_pyramid, grad_pyramid

torch.set_num_threads(1)

f32 = np.float32
_SRC = (Path(__file__).resolve().parent.parent / "larvio_tpu_torch" / "csrc" / "pyramid.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"^#define {name} (\d+)", _SRC, re.M).group(1))


PD_TX, PD_TY, PD_THREADS = _define("PD_TX"), _define("PD_TY"), _define("PD_THREADS")
SC_TX, SC_TY, SC_THREADS = _define("SC_TX"), _define("SC_TY"), _define("SC_THREADS")
SC_RUN = SC_TY * SC_TX // SC_THREADS
LEVELS = 3
SHAPES = [(480, 752), (480, 640), (479, 751), (61, 97), (7, 5)]  # (H, W)


def _k5(p0, p1, p2, p3, p4):
    acc = p0 * f32(1 / 16)
    acc = acc + p1 * f32(4 / 16)
    acc = acc + p2 * f32(6 / 16)
    acc = acc + p3 * f32(4 / 16)
    return acc + p4 * f32(1 / 16)


def _smooth3(a, b, c):
    return (a * f32(3 / 32) + b * f32(10 / 32)) + c * f32(3 / 32)


def _diff3(a, c):
    return a * f32(-1) + c * f32(1)


def _clamped_tile(img, ys, xs, rows, cols):
    """The block's shared-memory tile: rows ys.., columns xs.., each index clamped into the image."""
    H, W = img.shape
    y = np.clip(np.arange(ys, ys + rows), 0, H - 1)
    x = np.clip(np.arange(xs, xs + cols), 0, W - 1)
    return img[np.ix_(y, x)]


def _emulate_pyr_down(img):
    """``pyr_down_kernel`` over one lane: grid (tiles x, tiles y), each block
    loading level L's rows and columns 2 i0 - 2 .. of its tile."""
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    out = np.full((Ho, Wo), np.nan, f32)
    for by in range(-(-Ho // PD_TY)):
        for bx in range(-(-Wo // PD_TX)):
            i0, j0 = by * PD_TY, bx * PD_TX
            tile = _clamped_tile(img, 2 * i0 - 2, 2 * j0 - 2, 2 * PD_TY + 3, 2 * PD_TX + 3)
            # the row pass at the even rows: the tile's rows 2r .. 2r+4
            rp = _k5(*(tile[t:t + 2 * PD_TY:2] for t in range(5)))
            rpe, rpo = rp[:, 0::2], rp[:, 1::2]
            assert rpe.shape[1] == PD_TX + 2 and rpo.shape[1] == PD_TX + 1
            # the column pass at the even columns: the tile's columns 2c .. 2c+4
            blk = _k5(rpe[:, :PD_TX], rpo[:, :PD_TX], rpe[:, 1:PD_TX + 1], rpo[:, 1:PD_TX + 1], rpe[:, 2:])
            h, w = min(PD_TY, Ho - i0), min(PD_TX, Wo - j0)
            out[i0:i0 + h, j0:j0 + w] = blk[:h, :w]
    return out


def _emulate_scharr(pyr):
    """``scharr_kernel`` over one lane's levels: one grid over the tiles of
    every level; thread t of a block takes column t % SC_TX and SC_RUN rows."""
    tiles = []
    for lvl, im in enumerate(pyr):
        H, W = im.shape
        tiles += [(lvl, ty, tx) for ty in range(-(-H // SC_TY)) for tx in range(-(-W // SC_TX))]
    gx = [np.full(im.shape, np.nan, f32) for im in pyr]
    gy = [np.full(im.shape, np.nan, f32) for im in pyr]
    t = np.arange(SC_THREADS)
    c, r0 = t % SC_TX, (t // SC_TX) * SC_RUN
    for lvl, ty, tx in tiles:
        im = pyr[lvl]
        H, W = im.shape
        y0, x0 = ty * SC_TY, tx * SC_TX
        tile = _clamped_tile(im, y0 - 1, x0 - 1, SC_TY + 2, SC_TX + 2)
        x = x0 + c
        live = x < W
        a = [tile[r0, c + d] for d in range(3)]
        b = [tile[r0 + 1, c + d] for d in range(3)]
        for i in range(SC_RUN):
            y = y0 + r0 + i
            n = [tile[r0 + i + 2, c + d] for d in range(3)]
            s0, s2 = _smooth3(a[0], b[0], n[0]), _smooth3(a[2], b[2], n[2])
            d0, d1, d2 = (_diff3(a[k], n[k]) for k in range(3))
            m = live & (y < H)
            gx[lvl][y[m], x[m]] = _diff3(s0, s2)[m]
            gy[lvl][y[m], x[m]] = _smooth3(d0, d1, d2)[m]
            a, b = b, n
    return list(zip(gx, gy))


def _images(H, W, lanes, seed):
    """Smooth texture, noise, sharp steps at the edges and a constant patch:
    every tap and clamp sees varied values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(f32)
    out = []
    for b in range(lanes):
        img = (120 + 60 * np.sin(xx / (7 + b)) * np.cos(yy / 11) + rng.uniform(0, 40, (H, W))).astype(f32)
        img[:3, :] = 255.0
        img[:, -2:] = 0.0
        img[H // 3:H // 2, W // 3:W // 2] = 77.0
        out.append(img)
    return np.stack(out)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, f32)).view(np.int32)


def _assert_bits(got, ref, what):
    assert got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}"
    assert np.array_equal(_bits(got), _bits(ref)), f"{what}: the bits differ"


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES)
def test_kernels_emulated_equal_plain_chain(H, W, lanes):
    """Every level and every gradient image of the emulated kernels equals
    the plain chain's bits; each lane equals its own one-image run."""
    imgs = _images(H, W, lanes, seed=H + W)
    x = torch.from_numpy(imgs if lanes > 1 else imgs[0])
    ref_pyr = plain.build_pyramid(x, LEVELS)
    ref_grad = make_grad_pyramid(ref_pyr)
    ref_pyr = [p.numpy().reshape(lanes, *p.shape[-2:]) for p in ref_pyr]
    ref_grad = [(g[0].numpy().reshape(ref_pyr[i].shape), g[1].numpy().reshape(ref_pyr[i].shape))
                for i, g in enumerate(ref_grad)]
    for b in range(lanes):
        pyr = [imgs[b]]
        for _ in range(LEVELS):
            pyr.append(_emulate_pyr_down(pyr[-1]))
        assert [p.shape for p in pyr] == [(-(-H // 2**k), -(-W // 2**k)) for k in range(LEVELS + 1)]
        grad = _emulate_scharr(pyr)
        one = plain.build_pyramid(torch.from_numpy(imgs[b].copy()), LEVELS)
        one_grad = make_grad_pyramid(one)
        for lvl in range(LEVELS + 1):
            _assert_bits(pyr[lvl], ref_pyr[lvl][b], f"lane {b} level {lvl}")
            _assert_bits(one[lvl].numpy(), ref_pyr[lvl][b], f"lane {b} level {lvl} alone")
            for a, name in enumerate("xy"):
                _assert_bits(grad[lvl][a], ref_grad[lvl][a][b], f"lane {b} level {lvl} g{name}")
                _assert_bits(one_grad[lvl][a].numpy(), ref_grad[lvl][a][b], f"lane {b} level {lvl} g{name} alone")


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES[:2])
def test_cpu_dispatch_is_the_plain_chain(H, W, lanes):
    """CPU tensors take the plain chain: its tensors, bit for bit, and no
    launch counted."""
    imgs = _images(H, W, lanes, seed=7)
    x = torch.from_numpy(imgs if lanes > 1 else imgs[0])
    n0 = (build_pyramid.launches, build_pyramid.launches_batched,
          grad_pyramid.launches, grad_pyramid.launches_batched)
    pyr = build_pyramid(x, LEVELS)
    grad = grad_pyramid(tuple(pyr))
    ref = plain.build_pyramid(x, LEVELS)
    ref_grad = make_grad_pyramid(ref)
    assert pyr[0] is x and len(pyr) == LEVELS + 1 and len(grad) == LEVELS + 1
    for lvl in range(LEVELS + 1):
        assert torch.equal(pyr[lvl].view(torch.int32), ref[lvl].view(torch.int32))
        for a in range(2):
            assert torch.equal(grad[lvl][a].view(torch.int32), ref_grad[lvl][a].view(torch.int32))
    assert (build_pyramid.launches, build_pyramid.launches_batched,
            grad_pyramid.launches, grad_pyramid.launches_batched) == n0

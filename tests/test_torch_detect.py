"""The fleet's corner detection, ``ops/detect_cuda.py::detect_corners``, on the CPU.

On the CPU ``detect_corners`` is the plain chain
``grid_topk(nms(shi_tomasi_response(.)))``. Against the JAX package's chain
on rendered frames at both benchmark shapes (752x480 with k 10 and border
18, 640x480 with k 4 and border 20), with no lane axis and with 3 lanes
(each lane equal to its own single-image call bit for bit): the positions
equal bit for bit, the scores within the response's parity tolerance of
``tests/test_torch_frontend_ops.py`` (rtol 1e-5: XLA's response differs
from the port's in the last bits of ~0.6% of the pixels; given one
response, ``nms`` and ``grid_topk`` are exact there). On a constant image
both are exact: every score 0, the first k in-cell indices first.

The kernel (``csrc/detect.cu``) runs only on the card
(``tests/test_torch_cuda.py`` holds it to the plain chain there). Its row
sweep is emulated here in numpy, thread column by thread column and step by
step as the kernel schedules it (the four pipelined stages, the double
buffers, the edge fills, the van Herk column max, the per-thread lists and
the padding),
and must give the plain chain's bits on images whose cells have padding rows
and columns, at several radii, borders and k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.config import CameraConfig, VioConfig
from larvio_tpu.data.render import Renderer as JRenderer
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.ops import detect as jdet
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.detect_cuda import detect_corners

torch.set_num_threads(1)


def _render(W, H, times):
    s = W / 752
    cfg = VioConfig(camera=CameraConfig(width=W, height=H,
                                        intrinsics=tuple(v * s for v in (458.654, 457.296, 367.215, 248.375))))
    sim = Simulator(SimConfig(duration=8.0), cfg)
    rend = JRenderer(cfg, np.asarray(sim.landmarks))
    out = []
    for t in times:
        p_w, R_wi = sim.pose(np.asarray(t))
        R_ci = np.asarray(sim.R_ci)
        p_cam = p_w + R_wi.T @ (-R_ci.T @ np.asarray(sim.t_ci))
        out.append(np.asarray(rend.render(jnp.asarray((R_ci @ R_wi).T, jnp.float32),
                                          jnp.asarray(p_cam, jnp.float32))))
    return np.stack(out)


def _jax_chain(img, k, border):
    s, xy = jdet.grid_topk(jdet.nms(jdet.shi_tomasi_response(jnp.asarray(img)), 7), 4, 5, k, border=border)
    return np.asarray(s), np.asarray(xy)


def _assert_bits(got, ref):
    np.testing.assert_array_equal(np.asarray(got[0]).view(np.int32), np.asarray(ref[0]).view(np.int32))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def _assert_jax_parity(got, ref):
    np.testing.assert_allclose(np.asarray(got[0]), ref[0], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(np.asarray(got[1]), ref[1])


@pytest.mark.parametrize("W,k,border", [(752, 10, 18), (640, 4, 20)])
def test_detect_corners_matches_jax_chain(W, k, border):
    imgs = _render(W, 480, [2.0, 4.5, 6.0])
    batched = detect_corners(torch.from_numpy(imgs), 4, 5, k, border, 7)
    assert batched[0].shape == (3, 20, k) and batched[1].shape == (3, 20, k, 2)
    for b in range(3):
        one = detect_corners(torch.from_numpy(imgs[b].copy()), 4, 5, k, border, 7)
        _assert_jax_parity(one, _jax_chain(imgs[b], k, border))
        _assert_bits((batched[0][b], batched[1][b]), one)
        assert (one[0] > 15.0).sum().item() >= 20  # real corners, not only ties


def test_detect_corners_constant_image():
    img = np.full((480, 752), 93.0, np.float32)
    scores, xy = detect_corners(torch.from_numpy(img), 4, 5, 10, 18, 7)
    _assert_bits((scores, xy), _jax_chain(img, 10, 18))
    assert not scores.any().item()
    cell = torch.arange(20)
    want = torch.stack([(cell % 5 * 151)[:, None] + torch.arange(10), (cell // 5 * 120)[:, None].expand(20, 10)], -1)
    assert torch.equal(xy, want.float())


# ---- the kernel's row sweep, emulated -----------------------------------------

f32 = np.float32
NINF = f32(-np.inf)


def _key(v, idx):
    """The kernel's candidate key: the value's radix order, then the index reversed."""
    bits = (v + f32(0)).view(np.uint32).astype(np.uint64)
    o = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return (o << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(idx, np.uint64))


def _max_nan(a, b):
    return np.where(np.isnan(a) | np.isnan(b), f32(np.nan), np.maximum(a, b))


def _top_insert(lst, key):
    """A thread's list keeps its k largest keys, largest first."""
    lst[:] = sorted(lst + [int(key)], reverse=True)[:len(lst)]


def _emulate_block(img, cr, cc, ch, cw, k, border, r):
    """One block of ``detect_kernel``: every array is indexed by thread."""
    H, W = img.shape
    h, win = 3 + r, 2 * r + 1
    Y0, X0 = cr * ch, cc * cw
    Y1, X1 = min(Y0 + ch, H), min(X0 + cw, W)
    bd = ((min(cw + 2 * h, W) + 31) // 32) * 32
    lists = [[0] * k for _ in range(bd)]
    t = np.arange(bd)
    if Y0 < H and X0 < W:
        Xlo, Xhi = max(X0 - h, 0), min(X1 + h, W)
        n = Xhi - Xlo
        tl = np.minimum(t, n - 1)
        c = Xlo + tl
        nb = [np.clip(np.clip(c + d, 0, W - 1) - Xlo, 0, n - 1) for d in range(-2, 3)]
        rsrd, vs = np.zeros((2, 2, bd), f32), np.zeros((2, 3, bd), f32)
        vm = np.full((2, bd + 2 * r), NINF, f32)  # column maxima between -inf margins
        raw, suf = np.full((win, bd), NINF, f32), np.full((win, bd), NINF, f32)
        pmax = np.full(bd, NINF, f32)
        w = np.zeros((3, bd), f32)
        q = np.zeros((5, 3, bd), f32)
        resp_c = np.zeros(bd, f32)
        for s in range(Y1 - Y0 + 2 * r + 9):
            rd_h, wr_h = (s + 1) & 1, s & 1
            ry = Y0 - h - 6 - r + s  # 4.
            if Y0 <= ry < Y1:
                m = vm[rd_h][tl]
                for d in range(1, win):
                    m = _max_nan(m, vm[rd_h][tl + d])
                v = np.where(resp_c >= m, resp_c, f32(0))
                if ry < border or ry >= H - border:
                    v[:] = 0
                v = np.where((c < border) | (c >= W - border), f32(0), v)
                keys = _key(v, (ry - Y0) * cw + (c - X0))
                for i in np.nonzero((t < n) & (c >= X0) & (c < X1))[0]:
                    _top_insert(lists[i], keys[i])
            g = []  # 3.
            for a in range(3):
                va = vs[rd_h, a]
                acc = va[nb[0]] * f32(0.2)
                for j in range(1, 5):
                    acc = acc + va[nb[j]] * f32(0.2)
                g.append(acc)
            tr = (g[0] + g[1]) * f32(0.5)
            a = (g[0] - g[1]) * f32(0.5)
            det2 = a * a + g[2] * g[2]
            det2 = np.where(det2 < 0, f32(0), det2)
            rr = Y0 - h - 5 + s
            x = tr - np.sqrt(det2) if 0 <= rr < H else np.full(bd, NINF, f32)
            slot = s % win
            raw[slot] = x
            pmax = x if slot == 0 else _max_nan(pmax, x)
            if Y0 <= rr - r < Y1:  # van Herk: the last block's suffix maxima, this block's running max
                mv = pmax if slot == win - 1 else _max_nan(suf[slot + 1], pmax)
                vm[wr_h, r:r + bd] = np.where(t < n, mv, NINF)
                resp_c = raw[(slot + r + 1) % win].copy()
            if slot == win - 1:
                suf[slot] = x
                for j in range(win - 2, -1, -1):
                    suf[j] = _max_nan(raw[j], suf[j + 1])
            rs, rd = rsrd[rd_h]  # 2.
            gx = rs[nb[1]] * f32(-1) + rs[nb[3]] * f32(1)
            gy = rd[nb[1]] * f32(3 / 32) + rd[nb[2]] * f32(10 / 32) + rd[nb[3]] * f32(3 / 32)
            p = np.stack([gx * gx, gy * gy, gx * gy])
            rp = Y0 - h - 2 + s
            q = np.broadcast_to(p, q.shape).copy() if rp == 0 else np.concatenate([q[1:], q[-1:] if rp >= H else p[None]])
            acc = q[0] * f32(0.2)
            for j in range(1, 5):
                acc = acc + q[j] * f32(0.2)
            vs[wr_h] = acc
            w = np.concatenate([w[1:], img[min(max(Y0 - h + s, 0), H - 1)][c][None]])  # 1.
            rsrd[wr_h, 0] = w[0] * f32(3 / 32) + w[1] * f32(10 / 32) + w[2] * f32(3 / 32)
            rsrd[wr_h, 1] = w[0] * f32(-1) + w[2] * f32(1)
    nr = max(min(ch, H - Y0), 0)  # the padding
    pc = max(X0 + cw - W, 0) if X0 < W else cw
    pad = [(cy, cw - pc + i) for cy in range(nr) for i in range(pc)] + \
          [(cy, cx) for cy in range(nr, ch) for cx in range(cw)]
    for i, (cy, cx) in enumerate(pad):
        _top_insert(lists[i % bd], _key(np.zeros(1, f32), cy * cw + cx)[0])
    top = sorted((key for lst in lists for key in lst), reverse=True)[:k]  # the block-wide rounds
    o = np.array([key >> 32 for key in top], np.uint64)
    bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF).astype(np.uint32)
    idx = np.array([0xFFFFFFFF - (key & 0xFFFFFFFF) for key in top])
    return bits.view(np.float32), np.stack([X0 + idx % cw, Y0 + idx // cw], -1).astype(np.float32)


@pytest.mark.parametrize("H,W,rows,cols,k,border,r", [
    (48, 75, 2, 3, 6, 4, 7),  # 25-px cells, the NMS halo wider than the border
    (37, 53, 3, 4, 5, 3, 2),  # padding rows and columns
    (30, 41, 2, 2, 12, 0, 1),  # no border, k larger than a row of a thread's column
])
def test_kernel_sweep_emulated_equals_plain(H, W, rows, cols, k, border, r):
    rng = np.random.default_rng(H)
    noise = rng.uniform(0, 255, (H, W)).astype(f32)
    smooth = torch.nn.functional.avg_pool2d(torch.from_numpy(noise)[None, None], 5, 1, 2)[0, 0].numpy()
    lattice = np.zeros((H, W), f32)
    lattice[::4, ::4] = 50.0
    for img in (noise, smooth, lattice, np.full((H, W), 7.0, f32)):
        ch, cw = -(-H // rows), -(-W // cols)
        cells = [_emulate_block(img, i // cols, i % cols, ch, cw, k, border, r) for i in range(rows * cols)]
        ref = grid_topk(nms(shi_tomasi_response(torch.from_numpy(img)), r), rows, cols, k, border=border)
        _assert_bits((np.stack([c[0] for c in cells]), np.stack([c[1] for c in cells])), ref)

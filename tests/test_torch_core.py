"""Parity of the PyTorch port's core numerics with the JAX package.

Same numpy inputs (seeded) through ``larvio_tpu.core`` and
``larvio_tpu_torch.core``. Tolerances: quaternion / SO(3) / camera rtol 1e-5,
atol 1e-6 (f32 rounding); Householder projected information 2e-3 (as
tests/test_filter.py); ``inv_quadform`` finite results within 1e-3 relative
and +inf exactly where JAX gives +inf; ``psd_factor`` implied S S^T within
1e-4 x max diag; the JAX-order prefix scan bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.config import CameraConfig
from larvio_tpu.core import camera as jcam
from larvio_tpu.core import chi2 as jchi2
from larvio_tpu.core import linalg as jla
from larvio_tpu.core import quaternion as jq
from larvio_tpu.core import so3 as jso3
from larvio_tpu_torch.core import camera as tcam
from larvio_tpu_torch.core import chi2 as tchi2
from larvio_tpu_torch.core import linalg as tla
from larvio_tpu_torch.core import quaternion as tq
from larvio_tpu_torch.core import scan as tscan
from larvio_tpu_torch.core import so3 as tso3

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **(kw or TOL))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["multiply", "to_rotation", "roundtrip", "small_angle", "rk4", "inverse"])
def test_quaternion(rng, fn):
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    if fn == "multiply":
        _close(tq.quat_multiply(_t(q1), _t(q2)), jq.quat_multiply(q1, q2))
    elif fn == "to_rotation":
        _close(tq.quat_to_rotation(_t(q1)), jq.quat_to_rotation(q1))
    elif fn == "roundtrip":
        R = np.asarray(jq.quat_to_rotation(q1))
        _close(tq.rotation_to_quat(_t(R)), jq.rotation_to_quat(R), rtol=1e-5, atol=2e-6)
    elif fn == "small_angle":
        d = rng.normal(size=(64, 3)).astype(np.float32) * np.float32(0.5)
        d[:8] *= 10.0  # the |dθ/2| >= 1 renormalization branch
        _close(tq.small_angle_quat(_t(d)), jq.small_angle_quat(d))
    elif fn == "rk4":
        w0, w1 = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
        _close(tq.quat_integrate_rk4(_t(q1), _t(w0), _t(w1), 0.005),
               jq.quat_integrate_rk4(q1, w0, w1, 0.005))
    else:
        _close(tq.quat_inverse(_t(q1)), jq.quat_inverse(q1))


@pytest.mark.parametrize("fn", ["skew", "exp", "exp_small", "log"])
def test_so3(rng, fn):
    phi = rng.normal(size=(64, 3)).astype(np.float32)
    if fn == "skew":
        _close(tso3.skew(_t(phi)), jso3.skew(phi))
    elif fn == "exp":
        _close(tso3.so3_exp(_t(phi)), jso3.so3_exp(phi))
    elif fn == "exp_small":
        small = phi * np.float32(1e-7)
        _close(tso3.so3_exp(_t(small)), jso3.so3_exp(small))
    else:
        R = np.asarray(jso3.so3_exp(phi * np.float32(0.5)))
        _close(tso3.so3_log(_t(R)), jso3.so3_log(R), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_camera(rng, model):
    cam = CameraConfig()
    if model == "equidistant":
        cam = CameraConfig(distortion_model="equidistant",
                           distortion_coeffs=(-0.013, 0.02, -0.01, 0.002))
    xy = rng.uniform(-0.6, 0.6, size=(256, 2)).astype(np.float32)
    px = np.asarray(jcam.project(xy, cam))
    _close(tcam.project(_t(xy), cam), px, rtol=1e-5, atol=1e-4)  # pixel units
    _close(tcam.undistort_normalize(_t(px), cam), jcam.undistort_normalize(px, cam))


def test_chi2_tables_identical():
    dof = np.arange(-2, 600, dtype=np.int32)
    for conf in (0.95, 0.99):
        np.testing.assert_array_equal(
            tchi2.chi2_inv(_t(dof), conf).numpy(), np.asarray(jchi2.chi2_inv(jnp.asarray(dof), conf))
        )


@pytest.mark.parametrize("n", [1, 2, 7, 24, 200, 201])
def test_scan_matches_jnp_cumsum_bitwise(rng, n):
    x = (rng.uniform(size=n) < 0.7).astype(np.float32) + np.float32(1e-6)
    x = x * rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    np.testing.assert_array_equal(tscan.cumsum(_t(x)).numpy(), np.asarray(jnp.cumsum(x)))


@pytest.mark.parametrize("case", ["padded", "batched"])
def test_householder_eliminate(rng, case):
    """Projected information H^T H and H^T r match JAX to 2e-3; the padding
    rows stay exactly zero."""
    m, n_valid = 12, 8
    B_ = 3 if case == "batched" else 1
    A = rng.normal(size=(B_, m, 3)).astype(np.float32)
    B = rng.normal(size=(B_, m, 10)).astype(np.float32)
    r = rng.normal(size=(B_, m)).astype(np.float32)
    A[:, n_valid:], B[:, n_valid:], r[:, n_valid:] = 0.0, 0.0, 0.0
    got = tla.householder_eliminate(_t(A), _t(B), _t(r), 3)
    for b in range(B_):
        ref = jla.householder_eliminate(jnp.asarray(A[b]), jnp.asarray(B[b]), jnp.asarray(r[b]), 3)
        Bp, rp = got[0][b].numpy(), got[1][b].numpy()
        Bj, rj = np.asarray(ref[0]), np.asarray(ref[1])
        np.testing.assert_allclose(Bp.T @ Bp, Bj.T @ Bj, atol=2e-3)
        np.testing.assert_allclose(Bp.T @ rp, Bj.T @ rj, atol=2e-3)
        np.testing.assert_array_equal(Bp[n_valid:], 0.0)
        np.testing.assert_array_equal(Bp[:3], 0.0)
        _close(got[3][0][b], ref[3][0], rtol=1e-4, atol=1e-4)  # eliminated A rows


def test_solve3_inv3(rng):
    A = rng.normal(size=(32, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    _close(tla.solve3(_t(A), _t(b)), jla.solve3(A, b), rtol=1e-5, atol=1e-5)
    _close(tla.inv3(_t(A)), jla.inv3(A), rtol=1e-5, atol=1e-5)


def _spd(rng, n, cond, jitter=1e-3):
    """tests/test_core.py's construction: log-spaced spectrum 1..cond."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    S = ((Q * np.logspace(0, np.log10(cond), n)) @ Q.T + jitter * np.eye(n)).astype(np.float32)
    return 0.5 * (S + S.T)


@pytest.mark.parametrize("cond", [1e1, 1e2, 1e3, 1e4, 3e4, 1e6])
def test_inv_quadform(rng, cond):
    """Newton-Schulz chi2 quadform: finite results agree with JAX (1e-3 rel
    inside the gate's envelope, cond <= 3e4; 25% at cond 1e6 as the JAX
    guard test allows); +inf exactly where JAX gives +inf."""
    n = 40
    S = np.stack([_spd(rng, n, cond, jitter=0.0 if cond > 3e4 else 1e-3) for _ in range(3)])
    r = rng.normal(size=(3, n)).astype(np.float32)
    got = tla.inv_quadform(_t(S), _t(r)).numpy()
    ref = np.array([float(jla.inv_quadform(jnp.asarray(S[i]), jnp.asarray(r[i]))) for i in range(3)])
    assert np.array_equal(np.isinf(got), np.isinf(ref)), (got, ref)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-3 if cond <= 3e4 else 0.25)


def test_inv_quadform_indefinite(rng):
    n = 40
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, 3, n)
    lam[0] = -1.0  # negative eigenvalue: both must reject
    S = ((Q * lam) @ Q.T).astype(np.float32)
    S = 0.5 * (S + S.T)
    r = rng.normal(size=n).astype(np.float32)
    assert tla.inv_quadform(_t(S), _t(r)).item() == np.inf
    assert float(jla.inv_quadform(jnp.asarray(S), jnp.asarray(r))) == np.inf


def test_inv_quadform_nan():
    S = np.eye(4, dtype=np.float32)
    S[1, 2] = np.nan
    got = tla.inv_quadform(_t(S), torch.ones(4)).item()
    assert got == float(jla.inv_quadform(jnp.asarray(S), jnp.ones(4))) == np.inf


@pytest.mark.parametrize("case", ["wide", "padded_rows", "square"])
def test_psd_factor(rng, case):
    D, W = 20, 35
    M = rng.normal(size=(D, W)).astype(np.float32)
    if case == "padded_rows":
        M[5:8] = 0.0
    if case == "square":
        M = M[:, :D]
    St = tla.psd_factor(_t(M)).numpy()
    Sj = np.asarray(jla.psd_factor(jnp.asarray(M)))
    Pt, Pj = St @ St.T, Sj @ Sj.T
    np.testing.assert_allclose(Pt, Pj, atol=1e-4 * np.abs(np.diag(Pj)).max())
    np.testing.assert_allclose(Pt, M @ M.T, atol=1e-4 * np.abs(np.diag(Pj)).max())


def test_psd_factor_fallbacks():
    """NaN-poisoned input -> the diagonal fallback, as in JAX."""
    M = np.eye(6, 9, dtype=np.float32)
    M[2, 3] = np.nan
    _close(tla.psd_factor(_t(M)), jla.psd_factor(jnp.asarray(M)))


def test_psd_chol(rng):
    A = rng.normal(size=(15, 15)).astype(np.float32)
    Q = (A @ A.T * 1e-4).astype(np.float32)
    _close(tla.psd_chol(_t(Q)), jla.psd_chol(jnp.asarray(Q)), rtol=1e-4, atol=1e-7)
    # non-PD -> the identity-factor fallback (scaled by sqrt diag), as in JAX
    Qbad = np.diag(np.ones(4, np.float32))
    Qbad[0, 1] = Qbad[1, 0] = 3.0
    _close(tla.psd_chol(_t(Qbad)), jla.psd_chol(jnp.asarray(Qbad)))


def test_linalg_needs_no_jax_device_state():
    # the JAX oracles in this module run on the CPU backend
    assert jax.devices()[0].platform == "cpu"

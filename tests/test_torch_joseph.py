"""Parity of the port's Joseph (dense covariance) path, ``sqrt_form=False``,
with the JAX package.

One small hybrid configuration in dense form (F = 32 feature slots, C = 6
clones, S = 2 SLAM slots, a 320x240 camera with scaled intrinsics) serves
every test; both packages' configs come from one dict
(``convert.config_from_dict``). A JAX filter runs 5 s of simulator features;
its mid-sequence states are converted with ``from_reference`` and each
ported function is held against its JAX counterpart (jitted once) on the
same state and inputs; ``qr_compress`` and ``joseph_update`` on seeded numpy
inputs.

Tolerances: q, bg, ba, td, extrinsic atol 5e-5; v, p, idp atol 5e-4; the
dense P itself within 3e-3 of max|P| (the ROADMAP's step tolerance) and
symmetric within 1e-5 of max|P| (the JAX package's own P reaches 3.8e-6 on
this sequence: the augmentation block J P J^T is one product, not
mirrored); masks, slots, ids and counts exact. The compressed systems:
H_c^T H_c within 1e-4 of max|H^T H|, H_c^T r_c within 1e-4 of
sqrt(max|H^T H|) max|r|, the Cholesky-based H_c and r_c themselves within
1e-3 of their largest entries. The short
feature-level sequence (both packages free-running over 5 s): masks and
counts on every frame exact, positions within 1e-3 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.api import make_frame_inputs
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.core import linalg as jlin
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.init import flexible as jflex
from larvio_tpu.models import augmentation as jaug
from larvio_tpu.models import initializer as jinit
from larvio_tpu.models import msckf as jmsckf
from larvio_tpu.models import propagation as jprop
from larvio_tpu.models import prune as jprune
from larvio_tpu.models import slam as jslam
from larvio_tpu.models import state as jstate
from larvio_tpu.models import triangulation as jtri
from larvio_tpu.models import update as jupd
from larvio_tpu.models import zupt as jzupt
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.core import linalg as tlin
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.init import flexible as tflex
from larvio_tpu_torch.models import augmentation as taug
from larvio_tpu_torch.models import initializer as tinit
from larvio_tpu_torch.models import msckf as tmsckf
from larvio_tpu_torch.models import propagation as tprop
from larvio_tpu_torch.models import prune as tprune
from larvio_tpu_torch.models import slam as tslam
from larvio_tpu_torch.models import state as tstate
from larvio_tpu_torch.models import triangulation as ttri
from larvio_tpu_torch.models import update as tupd
from larvio_tpu_torch.models import zupt as tzupt
from larvio_tpu_torch.models.state import CLONE_DIM, IDX_P, IDX_TD, IDX_THETA, clone_offset, slam_offset
from vio_bench.compare import ref_cfg, to_reference
from vio_bench.reference.core import linalg as rlin
from vio_bench.reference.models import augmentation as raug
from vio_bench.reference.models import propagation as rprop
from vio_bench.reference.models import state as rstate

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=32),
    filter=FilterConfig(sqrt_form=False, max_slam_features=2, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60, max_update_features=12, max_prune_features=12,
                        slam_promote_obs=5),
)
TCFG = config_from_dict(dataclasses.asdict(CFG))
RCFG = ref_cfg(dataclasses.asdict(CFG))  # vio_bench/reference's classes, the same values
S, C, F = 2, 6, 32
D = jstate.state_dim(CFG)
assert not TCFG.filter.sqrt_form and CFG.filter.bootstrap_consume_k <= F


def _variant(**kw):
    """(JAX config, port config) with some filter options changed."""
    cfg = dataclasses.replace(CFG, filter=dataclasses.replace(CFG.filter, **kw))
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def _jit(fn, **kw):
    """The JAX oracle, compiled once per test module (cfg is static)."""
    return jax.jit(fn, static_argnums=0, **kw)


J_STEP = _jit(jmsckf.filter_step)
J_PROPAGATE = _jit(jprop.propagate)
J_AUGMENT = _jit(jaug.augment_state)
J_REMOVE = _jit(jprune.remove_clones)
J_TRIANGULATE = _jit(jtri.triangulate_batch)
J_APPLY = _jit(jupd.apply_update, static_argnames=("refactor",))
J_ZUPT = _jit(jzupt.zupt_update)
J_OWNED = _jit(jslam.slam_owned_rows)
J_MEAS = _jit(jslam.slam_measurement_blocks)
J_CONSUME = _jit(jmsckf._consume_blocks)
J_PROMOTE = _jit(jslam.promote_features)
J_REANCHOR = _jit(jslam.reanchor_on_prune)
J_DROP = _jit(jslam.drop_lost)
J_BLOCKS = _jit(lambda cfg, fs, p, u, m, t: jax.vmap(
    lambda p_, u_, m_, t_: jupd.feature_block(cfg, fs, p_, u_, m_, t_))(p, u, m, t))
J_PRUNE_BLOCKS = _jit(lambda cfg, fs, p, u, s, o, t: jax.vmap(
    lambda p_, u_, o_, t_: jupd.prune_feature_block(cfg, fs, p_, u_, s, o_, t_))(p, u, o, t))
J_QR = jax.jit(jlin.qr_compress, static_argnames=("mode",))
J_JOSEPH = jax.jit(jlin.joseph_update)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_reference(_np(tree), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _sim_frames(cfg, seed, duration=5.0):
    sim = Simulator(SimConfig(duration=duration, static_lead_in=1.0, n_landmarks=300, pixel_noise=0.002,
                              gyro_noise=0.005, acc_noise=0.05, seed=seed), cfg)
    return _np(make_frame_inputs(sim.generate()))


@pytest.fixture(scope="module")
def seq():
    """The JAX dense filter over 5 s of noisy simulator features; keeps
    every state: states[k] is the state before frame k."""
    feats, imu = _sim_frames(CFG, 3)
    vs = jmsckf.init_vio_state(CFG)
    states, outs = [vs], []
    for k in range(feats.t.shape[0]):
        vs, out = J_STEP(CFG, vs, jax.tree.map(lambda a: a[k], feats), jax.tree.map(lambda a: a[k], imu))
        states.append(vs)
        outs.append(_np(out))
    states = [_np(s) for s in states]
    n_live = np.array([int(s.filter.slam.valid.sum()) for s in states[:-1]])
    n_slam = np.array([int(o.n_slam) for o in outs])
    assert n_slam.max() == S and sum(int(o.did_reset) for o in outs) == 0
    live = [k for k in range(40, len(outs)) if n_live[k] == S and n_live[k - 1] == S]
    inited = [k for k in range(len(outs)) if bool(states[k].filter.initialized)]
    assert len(live) >= 3 and len(inited) > 40
    # the frame with the most accepted MSCKF features (an update every test sees)
    k = max(range(45, len(outs)), key=lambda k: int(outs[k].n_updated))
    assert int(outs[k].n_updated) >= 3
    return dict(states=states, outs=outs, feats=feats, imu=imu, live=live, k=k)


def _frame(seq, k):
    """Frame k's (FrameFeatures, ImuBatch) as numpy trees."""
    return jax.tree.map(lambda a: a[k], seq["feats"]), jax.tree.map(lambda a: a[k], seq["imu"])


def _newest(fs):
    return int(np.argmax(np.where(fs.clones.valid, fs.clones.frame, -1)))


def assert_P_close(P_got, P_ref):
    """The dense covariance itself, and its symmetry."""
    P_got, P_ref = np.asarray(P_got, np.float64), np.asarray(P_ref, np.float64)
    assert P_got.shape == P_ref.shape
    scale = np.abs(P_ref).max()
    np.testing.assert_allclose(P_got, P_ref, atol=3e-3 * scale)
    np.testing.assert_allclose(P_got, np.swapaxes(P_got, -1, -2), atol=1e-5 * scale)


def assert_filter_close(got, ref):
    """got: port FilterState; ref: JAX FilterState (numpy leaves)."""
    g = to_reference_numpy(got)
    for name in ("q", "bg", "ba", "td", "q_ci", "t_ci", "q_null"):
        np.testing.assert_allclose(g[name], np.asarray(getattr(ref, name)), atol=5e-5, err_msg=name)
    for name in ("v", "p", "v_null", "p_null", "time"):
        np.testing.assert_allclose(g[name], np.asarray(getattr(ref, name)), atol=5e-4, err_msg=name)
    for name in ("initialized", "stationary", "frame", "reset_count"):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("valid", "frame"):
        np.testing.assert_array_equal(g["clones"][name], np.asarray(getattr(ref.clones, name)), err_msg=name)
    np.testing.assert_allclose(g["clones"]["q"], np.asarray(ref.clones.q), atol=5e-5)
    np.testing.assert_allclose(g["clones"]["p"], np.asarray(ref.clones.p), atol=5e-4)
    np.testing.assert_array_equal(g["obs"]["valid"], np.asarray(ref.obs.valid))
    np.testing.assert_array_equal(g["obs"]["track_id"], np.asarray(ref.obs.track_id))
    for name in ("valid", "anchor_slot", "track_slot", "track_id", "age"):
        np.testing.assert_array_equal(g["slam"][name], np.asarray(getattr(ref.slam, name)), err_msg=name)
    for name in ("idp", "idp_null"):
        np.testing.assert_allclose(g["slam"][name], np.asarray(getattr(ref.slam, name)), atol=5e-4, err_msg=name)
    assert_P_close(g["P"], ref.P)


# --------------------------------------------------------------------------
# core/linalg.py: qr_compress and joseph_update on seeded inputs
# --------------------------------------------------------------------------


def _tall_system(seed, N=60, Dn=24, pad=12):
    """A whitened stack with zero padding rows (N > D) and its residual."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(N, Dn)).astype(np.float32)
    H[rng.choice(N, pad, replace=False)] = 0.0
    r = rng.normal(size=N).astype(np.float32)
    r[np.all(H == 0, axis=1)] = 0.0
    return H, r


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return ((A @ A.T) / n + 0.1 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("mode", ["cholqr2", "qr", "gram"])
def test_qr_compress_modes(mode):
    """The three compressions keep the normal equations; the Cholesky-based
    ones give the JAX package's H_c; a 3-lane batch equals each lane alone."""
    systems = [_tall_system(s) for s in (0, 1, 2)]
    H, r = systems[0]
    Hj, rj = (np.asarray(x, np.float64) for x in J_QR(jnp.asarray(H), jnp.asarray(r), mode=mode))
    Ht, rt = (x.numpy().astype(np.float64) for x in tlin.qr_compress(_t(H), _t(r), mode=mode))
    assert Ht.shape == (H.shape[1], H.shape[1]) and rt.shape == (H.shape[1],)
    H64, r64 = H.astype(np.float64), r.astype(np.float64)
    G, g = H64.T @ H64, H64.T @ r64
    for Hc, rc in ((Ht, rt), (Hj, rj)):
        np.testing.assert_allclose(Hc.T @ Hc, G, atol=1e-4 * np.abs(G).max())
        np.testing.assert_allclose(Hc.T @ rc, g, atol=1e-4 * np.abs(G).max() ** 0.5 * np.abs(r64).max())
    if mode != "qr":  # unique upper-triangular factors (positive diagonal)
        np.testing.assert_allclose(Ht, Hj, atol=1e-3 * np.abs(Hj).max())
        np.testing.assert_allclose(rt, rj, atol=1e-3 * np.abs(rj).max())
    Hb = torch.stack([_t(h) for h, _ in systems])
    rb = torch.stack([_t(x) for _, x in systems])
    Hcb, rcb = tlin.qr_compress(Hb, rb, mode=mode, lanes=1)
    for b, (h, x) in enumerate(systems):
        Hc1, rc1 = tlin.qr_compress(_t(h), _t(x), mode=mode)
        np.testing.assert_allclose(Hcb[b].numpy(), Hc1.numpy(), atol=1e-5 * np.abs(Hc1.numpy()).max())
        np.testing.assert_allclose(rcb[b].numpy(), rc1.numpy(), atol=1e-5 * np.abs(rc1.numpy()).max())


def test_qr_compress_nan_falls_back_to_the_diagonal():
    H, r = _tall_system(4)
    H[3, 5] = np.nan
    for mode in ("cholqr2", "gram"):
        Hj, rj = (np.asarray(x) for x in J_QR(jnp.asarray(H), jnp.asarray(r), mode=mode))
        Ht, rt = (x.numpy() for x in tlin.qr_compress(_t(H), _t(r), mode=mode))
        np.testing.assert_array_equal(np.isnan(Ht), np.isnan(Hj))
        np.testing.assert_array_equal(np.isnan(rt), np.isnan(rj))
        assert not np.isnan(rt).any(), mode


@pytest.mark.parametrize("n, noise", [(9, "vector"), (24, "scalar")])
def test_joseph_update(n, noise):
    """dx and the Joseph-form P' against the JAX package, P' symmetric; n
    below and at the state dimension."""
    Dn = 24
    P = _spd(5, Dn)
    rng = np.random.default_rng(6)
    H = rng.normal(size=(n, Dn)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32) * 0.1
    nv = (rng.uniform(0.5, 2.0, size=n).astype(np.float32) if noise == "vector" else np.float32(0.7))
    dj, Pj = J_JOSEPH(jnp.asarray(P), jnp.asarray(H), jnp.asarray(r), jnp.asarray(nv))
    dt, Pt = tlin.joseph_update(_t(P), _t(H), _t(r), _t(nv))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5 * np.abs(np.asarray(dj)).max())
    assert_P_close(Pt.numpy(), np.asarray(Pj))
    assert torch.equal(Pt, Pt.T)
    # a batch of lanes equals each lane alone
    Pb = torch.stack([_t(P), _t(_spd(7, Dn))])
    db, Pbn = tlin.joseph_update(Pb, torch.stack([_t(H)] * 2), torch.stack([_t(r)] * 2), _t(nv), lanes=1)
    d1, P1 = tlin.joseph_update(Pb[1], _t(H), _t(r), _t(nv))
    np.testing.assert_allclose(db[1].numpy(), d1.numpy(), atol=1e-6)
    np.testing.assert_allclose(Pbn[1].numpy(), P1.numpy(), atol=1e-6 * np.abs(P1.numpy()).max())


def test_joseph_update_failed_factorization_is_nan():
    """An indefinite innovation covariance gives NaN, as the JAX package's
    Cholesky does, so apply_update's finite guard rejects the update."""
    P = _spd(8, 12)
    H = np.eye(4, 12, dtype=np.float32)
    r = np.ones(4, np.float32)
    nv = np.float32(-50.0)
    dj, Pj = J_JOSEPH(jnp.asarray(P), jnp.asarray(H), jnp.asarray(r), jnp.asarray(nv))
    dt, Pt = tlin.joseph_update(_t(P), _t(H), _t(r), _t(nv))
    assert np.isnan(np.asarray(dj)).all() and torch.isnan(dt).all()
    assert not np.isfinite(np.asarray(Pj)).all() and not torch.isfinite(Pt).all()


# --------------------------------------------------------------------------
# the dense form against a textbook float64 EKF and vio_bench/reference
# --------------------------------------------------------------------------

# A gap over the largest element of the textbook result. The port works in
# float32: each element is a sum of at most a few hundred products of
# well-scaled terms (P's eigenvalues within [0.1, 5], R of the same order),
# whose rounding stays below 1e-5 of that scale (n * 2^-24 ~ 3e-6 at
# n = 48). P rounded to bfloat16 (8 mantissa bits, 2^-9 ~ 2e-3 per element)
# lands two orders above, so TEXTBOOK_TOL tells the two apart.
TEXTBOOK_TOL = 2e-5


def _gap(got, want):
    got = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rounded(P, planted):
    """P as given to the port: float32, or (``planted``) rounded to bfloat16."""
    P = _t(P)
    return P.to(torch.bfloat16).to(torch.float32) if planted else P


def _assert_textbook(gap, planted):
    if planted:
        assert gap > TEXTBOOK_TOL, gap  # the tolerance catches a bfloat16 P
    else:
        assert gap <= TEXTBOOK_TOL, gap


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [9, 48])
def test_joseph_update_against_textbook_ekf(n, planted):
    """K = P H^T (H P H^T + R)^-1, dx = K r and P+ = (I - KH) P (I - KH)^T
    + K R K^T in float64 against ``joseph_update`` on seeded P, H, R; a
    stack below and at the state dimension. vio_bench/reference's copy
    gives the port's bits on the CPU."""
    Dn = 48
    rng = np.random.default_rng(12 + n)
    P = _spd(13, Dn) * 2.0
    H = (rng.normal(size=(n, Dn)) / np.sqrt(Dn)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    R = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    P64, H64, R64 = P.astype(np.float64), H.astype(np.float64), np.diag(R.astype(np.float64))
    K = P64 @ H64.T @ np.linalg.inv(H64 @ P64 @ H64.T + R64)
    IKH = np.eye(Dn) - K @ H64
    want_P = IKH @ P64 @ IKH.T + K @ R64 @ K.T
    want_dx = K @ r.astype(np.float64)
    Pin = _rounded(P, planted)
    dx, Pn = tlin.joseph_update(Pin, _t(H), _t(r), _t(R))
    _assert_textbook(max(_gap(Pn, want_P), _gap(dx, want_dx)), planted)
    rdx, rPn = rlin.joseph_update(Pin, _t(H), _t(r), _t(R))
    assert torch.equal(dx, rdx) and torch.equal(Pn, rPn)


def _transition_inputs(seed):
    rng = np.random.default_rng(seed)
    P = _spd(seed, D) * 2.0
    Phi = (np.eye(15) + 0.05 * rng.normal(size=(15, 15))).astype(np.float32)
    Q = _spd(seed + 1, 15) * 1e-2
    q = rng.uniform(0.01, 0.1, size=3 * S).astype(np.float32)
    return P, Phi, Q, q


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("slam_noise", [False, True])
def test_dense_frame_transition_against_textbook(slam_noise, planted):
    """Phi P Phi^T + Q in float64, Phi = diag(Phi_imu, I) and Q =
    diag(Q_imu, 0) (with the SLAM rows' random walk q^2 on the diagonal),
    against ``_dense_frame_transition``; vio_bench/reference's copy gives
    the port's bits."""
    P, Phi, Q, q = _transition_inputs(21)
    Phi_full, Q_full = np.eye(D), np.zeros((D, D))
    Phi_full[:15, :15], Q_full[:15, :15] = Phi, Q
    if slam_noise:
        base = slam_offset(TCFG, 0)
        Q_full[base:base + 3 * S, base:base + 3 * S] = np.diag(q.astype(np.float64) ** 2)
    want = Phi_full @ P.astype(np.float64) @ Phi_full.T + Q_full
    slam_q = _t(q) if slam_noise else None
    Pin = _rounded(P, planted)
    got = tprop._dense_frame_transition(TCFG, Pin, _t(Phi), _t(Q), slam_q)
    _assert_textbook(_gap(got, want), planted)
    assert torch.equal(got, rprop._dense_frame_transition(RCFG, Pin, _t(Phi), _t(Q), slam_q))


@pytest.mark.parametrize("planted", [False, True])
def test_augmentation_against_textbook(planted):
    """A clone into free slot 3: P' = A P A^T in float64, A the identity
    with the slot's rows replaced by the clone Jacobian J (d clone / d
    [theta, p, td]), so the slot's block is J P J^T and its rows J P; against
    ``augment_state``; vio_bench/reference's copy gives the port's bits."""
    rng = np.random.default_rng(31)
    slot = 3
    off = int(clone_offset(slot))
    P = _spd(31, D) * 2.0
    P[off:off + CLONE_DIM] = 0.0  # a free slot's rows and columns are zero
    P[:, off:off + CLONE_DIM] = 0.0
    fs = tstate.init_filter_state(TCFG, "cpu")
    fs = fs.replace(P=_rounded(P, planted), v=_t(rng.normal(size=3).astype(np.float32)),
                    clones=fs.clones.replace(valid=torch.arange(C) < slot))
    w = rng.normal(size=3).astype(np.float32)
    J = np.zeros((CLONE_DIM, D))
    J[0:3, IDX_THETA:IDX_THETA + 3] = J[3:6, IDX_P:IDX_P + 3] = np.eye(3)
    J[0:3, IDX_TD], J[3:6, IDX_TD] = w, fs.v.numpy()
    A = np.eye(D)
    A[off:off + CLONE_DIM] = J
    want = A @ P.astype(np.float64) @ A.T
    got, got_slot = taug.augment_state(TCFG, fs, torch.tensor(True), _t(w))
    assert int(got_slot) == slot
    _assert_textbook(_gap(got.P, want), planted)
    ref, _ = raug.augment_state(RCFG, to_reference(rstate.init_filter_state(RCFG, "cpu"), fs, "cpu"),
                                torch.tensor(True), _t(w))
    assert torch.equal(got.P, ref.P)


# --------------------------------------------------------------------------
# the dense prior: init_filter_state, the static initializer, the reset
# --------------------------------------------------------------------------


def test_state_init_and_static_prior(seq):
    """init_filter_state and try_static_init put the dense prior diag(d)
    (not its square root) into P, as the JAX package does."""
    ref = _np(jstate.init_filter_state(CFG))
    got = to_reference_numpy(tstate.init_filter_state(TCFG, "cpu"))
    np.testing.assert_array_equal(got["P"], ref.P)
    acc_j, acc_t = jinit.InitAccumulator.zero(), tinit.InitAccumulator.zero("cpu")
    fs_j, fs_t = seq["states"][0].filter, _port(seq["states"][0].filter)
    for k in range(40):
        f, i = _frame(seq, k)
        acc_j = jinit.accumulate(acc_j, i, f.mean_motion)
        acc_t = tinit.accumulate(acc_t, _port(i), torch.tensor(f.mean_motion))
        fs_j, acc_j, dj = jinit.try_static_init(CFG, fs_j, acc_j)
        fs_t, acc_t, dt = tinit.try_static_init(TCFG, fs_t, acc_t)
        assert bool(dj) == bool(dt)
        if bool(dt):
            break
    assert bool(fs_t.initialized)
    d = tstate.initial_covariance_diag(TCFG)
    np.testing.assert_array_equal(fs_t.P.numpy(), np.diag(d))
    assert_filter_close(fs_t, _np(fs_j))


def test_reset_prior_is_the_dense_diagonal(seq):
    """A blown state (NaN velocity) resets to diag(d_reset) in dense form."""
    k = seq["live"][0]
    vs = seq["states"][k]
    vs = vs.replace(filter=vs.filter.replace(v=np.full(3, np.nan, np.float32)))
    f, i = _frame(seq, k)
    rj, oj = _np(J_STEP(CFG, vs, f, i))
    rt, ot = tmsckf.filter_step(TCFG, _port(vs), _port(f), _port(i))
    assert bool(oj.did_reset) and bool(ot.did_reset)
    np.testing.assert_array_equal(rt.filter.P.numpy(), rj.filter.P)
    assert np.array_equal(rj.filter.P, np.diag(np.diagonal(rj.filter.P)))
    assert int(ot.n_slam) == int(oj.n_slam) == 0


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_inject_init_result(mode):
    """The host initializer's injection puts initial_covariance itself into P."""
    rng = np.random.default_rng(0 if mode == "static" else 1)
    q = rng.normal(size=4)
    res = jflex.InitResult(q_wi=(q / np.linalg.norm(q)).astype(np.float32), v=rng.normal(size=3),
                           bg=rng.normal(0, 0.01, 3), ba=np.zeros(3), time=1.25, mode=mode)
    vs_j = jmsckf.init_vio_state(CFG)
    want = _np(jflex.inject_init_result(CFG, vs_j, res))
    got = tflex.inject_init_result(TCFG, _port(vs_j), tflex.InitResult(**vars(res)))
    g = to_reference_numpy(got)["filter"]
    for name in ("q", "v", "bg", "ba", "p", "time", "initialized"):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(want.filter, name)), err_msg=name)
    np.testing.assert_array_equal(g["P"], want.filter.P)
    np.testing.assert_array_equal(g["P"], tstate.initial_covariance(TCFG, torch.device("cpu"), mode=mode).numpy())
    assert got.filter.P.data_ptr() != tstate.initial_covariance(TCFG, torch.device("cpu"), mode=mode).data_ptr()


# --------------------------------------------------------------------------
# the dense modules, from converted mid-sequence states
# --------------------------------------------------------------------------


def test_convert_round_trip_exact(seq):
    ref = seq["states"][seq["live"][0]]
    back = to_reference_numpy(from_reference(ref, "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = back
        for p in path:
            node = node[p.name]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf), path
    assert back["filter"]["P"].shape == (D, D)


@pytest.mark.parametrize("slam_noise", [0.0, 0.05])
def test_propagate(seq, slam_noise):
    jcfg, tcfg = (CFG, TCFG) if slam_noise == 0.0 else _variant(slam_process_noise=slam_noise)
    k = seq["live"][0]
    fs = seq["states"][k].filter
    f, i = _frame(seq, k)
    ref = _np(J_PROPAGATE(jcfg, fs, i, f.t))
    got = tprop.propagate(tcfg, _port(fs), _port(i), _t(f.t))
    assert got.P.shape == ref.P.shape == (D, D)
    assert_filter_close(got, ref)


@pytest.mark.parametrize("do", [True, False])
def test_augmentation(seq, do):
    k = seq["k"]
    fs = seq["states"][k].filter
    f, i = _frame(seq, k)
    fs = _np(J_PROPAGATE(CFG, fs, i, f.t))
    fs = _np(J_REMOVE(CFG, fs, jnp.int32(0), jnp.int32(1), jnp.asarray(True)))
    w = np.asarray(i.w[-1]) - np.asarray(fs.bg)
    rj, sj = _np(J_AUGMENT(CFG, fs, jnp.asarray(do), jnp.asarray(w)))
    rt, st = taug.augment_state(TCFG, _port(fs), torch.tensor(do), _t(w))
    assert int(sj) == int(st)
    assert_filter_close(rt, rj)


@pytest.mark.parametrize("do", [True, False])
def test_remove_clones(seq, do):
    for vs in seq["states"][::-1]:  # the last state with a full window
        if int(vs.filter.clones.valid.sum()) == C:
            break
    fs = vs.filter
    aj, bj = jprune.select_redundant(CFG, fs)
    ref = _np(J_REMOVE(CFG, fs, aj, bj, jnp.asarray(do)))
    got = tprune.remove_clones(TCFG, _port(fs), torch.tensor(int(aj)), torch.tensor(int(bj)), torch.tensor(do))
    assert_filter_close(got, ref)
    if do:
        rows = tstate.clone_offset(int(aj)) + np.arange(6)
        assert not got.P.numpy()[rows].any() and not got.P.numpy()[:, rows].any()


@pytest.fixture(scope="module")
def blocks(seq):
    """The window's live rows of a propagated mid-sequence state (the first
    whose feature blocks accept >= 3 windows and whose prune blocks accept
    one): the JAX feature blocks and prune blocks, the port's on the same
    inputs."""
    slots = jnp.asarray([0, 1], jnp.int32)
    for k in range(40, len(seq["outs"])):
        f, i = _frame(seq, k)
        fs = _np(J_PROPAGATE(CFG, seq["states"][k].filter, i, f.t))
        uv, mask = fs.obs.uv, fs.obs.valid
        tri = _np(J_TRIANGULATE(CFG, jtri.camera_window(fs), fs.clones.frame, jnp.asarray(uv),
                                jnp.asarray(mask)))
        ref = _np(J_BLOCKS(CFG, fs, tri.p_w, uv, mask, tri.valid))
        ref_p = _np(J_PRUNE_BLOCKS(CFG, fs, tri.p_w, uv[:, :2], slots, mask[:, :2], tri.valid))
        if ref.accept.sum() >= 3 and ref_p[2].sum() >= 1:
            break
    got = tupd.feature_block(TCFG, _port(fs), _t(tri.p_w), _t(uv), _t(mask), _t(tri.valid))
    got_p = tupd.prune_feature_block(TCFG, _port(fs), _t(tri.p_w), _t(uv[:, :2]), torch.tensor([0, 1]),
                                     _t(mask[:, :2]), _t(tri.valid))
    return dict(fs=fs, ref=ref, got=got, ref_p=ref_p, got_p=got_p)


def test_feature_block_dense_gate(blocks):
    """The dense chi-square gate H P H^T + sigma^2 I: the same verdicts and rows."""
    ref, got = blocks["ref"], blocks["got"]
    np.testing.assert_array_equal(got.accept.numpy(), ref.accept)
    assert ref.accept.sum() >= 3
    Hg, Hr = got.H.numpy().astype(np.float64), ref.H.astype(np.float64)
    Ig, Ir = np.einsum("kij,kil->jl", Hg, Hg), np.einsum("kij,kil->jl", Hr, Hr)
    np.testing.assert_allclose(Ig, Ir, atol=1e-3 * np.abs(Ir).max())


def test_prune_feature_block_scalar_gate(blocks):
    ref_p, got_p = blocks["ref_p"], blocks["got_p"]
    np.testing.assert_array_equal(got_p[2].numpy(), ref_p[2])
    assert ref_p[2].sum() >= 1
    Hg, Hr = got_p[0].numpy().astype(np.float64), ref_p[0].astype(np.float64)
    np.testing.assert_allclose(Hg.T @ Hg, Hr.T @ Hr, atol=1e-3 * np.abs(Hr.T @ Hr).max())


@pytest.mark.parametrize("system", ["tall", "short"])
@pytest.mark.parametrize("enable", [True, False])
def test_apply_update(blocks, system, enable):
    """The stacked feature rows (n > D: qr_compress, then joseph_update) and
    their first 9 rows (n <= D: joseph_update on the rows themselves)."""
    fs, ref, ref_p = blocks["fs"], blocks["ref"], blocks["ref_p"]
    H = np.concatenate([ref.H.reshape(-1, D), ref_p[0]])
    r = np.concatenate([ref.r.reshape(-1), ref_p[1]])
    if system == "tall":
        assert H.shape[0] > D
    else:
        rows = np.argsort(~np.any(H != 0, axis=1), kind="stable")[:9]  # live rows first
        H, r = H[rows], r[rows]
        assert H.shape[0] == 9 < D
    nv = np.float32(CFG.noise.observation_noise**2)
    rj, dxj, okj = _np(J_APPLY(CFG, fs, jnp.asarray(H), jnp.asarray(r), nv, enable=jnp.asarray(enable)))
    rt, dxt, okt = tupd.apply_update(TCFG, _port(fs), _t(H), _t(r), torch.tensor(float(nv)),
                                     enable=torch.tensor(enable))
    assert bool(okj) == bool(okt)
    np.testing.assert_allclose(dxt.numpy(), dxj, atol=5e-5)
    assert_filter_close(rt, rj)


@pytest.mark.parametrize("stationary", [True, False])
def test_zupt(seq, stationary):
    """The 9-row ZUPT (n = 9 < D) through the unchanged zupt_update."""
    fs = seq["states"][seq["k"] + 1].filter
    ref = _np(J_ZUPT(CFG, fs, jnp.asarray(stationary)))
    got = tzupt.zupt_update(TCFG, _port(fs), torch.tensor(stationary))
    assert_filter_close(got, ref)


def test_slam_measurement_gate(seq):
    """The 2-row SLAM update's dense 2x2 gate against the features of the
    frame that made the newest clone."""
    for k in seq["live"]:
        fs = seq["states"][k].filter
        f, _ = _frame(seq, k - 1)
        Hj, rj, aj, hj = _np(J_MEAS(CFG, fs, f, jnp.int32(_newest(fs))))
        if aj.sum() >= 1:
            break
    Ht, rt, at, ht = tslam.slam_measurement_blocks(TCFG, _port(fs), _port(f), torch.tensor(_newest(fs)))
    assert aj.sum() >= 1
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)


def _candidates(fs):
    return np.asarray(fs.obs.track_id >= 0) & ~np.asarray(J_OWNED(CFG, fs))


@pytest.mark.parametrize("k_rho", [0.0, 2.0])
def test_promote_features_together(seq, k_rho):
    """Every SLAM slot freed, the wide consume channel, the hybrid update,
    then two features promoted together: their dense rows, columns, own
    blocks and the exact cross block between them."""
    jcfg, tcfg = (CFG, TCFG) if k_rho == 0.0 else _variant(slam_init_rho_inflation=k_rho,
                                                           slam_max_init_rho_sigma=3.0)
    for k in seq["live"]:
        fs = seq["states"][k].filter
        f, _ = _frame(seq, k - 1)
        fs = _np(J_DROP(CFG, fs, jax.tree.map(jnp.asarray, f), jnp.ones(S, bool)))
        blocks, _, idx, tri, sel = J_CONSUME(CFG, fs, jnp.asarray(_candidates(fs)), jnp.asarray(True))
        if int(np.sum(sel)) >= 2:
            break
    assert int(fs.slam.valid.sum()) == 0 and int(np.sum(sel)) >= 2
    fs2, dx, ok = J_APPLY(CFG, fs, blocks.H.reshape(-1, D), blocks.r.reshape(-1),
                          jnp.float32(CFG.noise.observation_noise**2), enable=jnp.asarray(True))
    assert bool(ok)
    anchor = jnp.int32(_newest(fs))
    ref = _np(J_PROMOTE(jcfg, fs2, blocks, tri, idx, sel, dx, anchor))
    assert int(ref.slam.valid.sum()) == S  # both slots taken in one promotion
    got = tslam.promote_features(
        tcfg, _port(fs2), tupd.FeatureBlock(*(_t(x) for x in _np(blocks))),
        ttri.TriangulationResult(*(_t(x) for x in _np(tri))), _t(idx), _t(sel), _t(dx),
        torch.tensor(int(anchor)))
    assert_filter_close(got, ref)
    base = tstate.slam_offset(TCFG, 0)
    cross_j, cross_t = ref.P[base:base + 3, base + 3:base + 6], got.P.numpy()[base:base + 3, base + 3:base + 6]
    assert np.abs(cross_j).max() > 0
    np.testing.assert_allclose(cross_t, cross_j, atol=3e-3 * np.abs(cross_j).max())


@pytest.mark.parametrize("do", [True, False])
def test_reanchor_on_prune(seq, do):
    """A forced prune of the clone anchoring the SLAM features: the row pass
    and its dense column mirror."""
    k = seq["live"][len(seq["live"]) // 2]
    fs = seq["states"][k].filter
    a = int(fs.slam.anchor_slot[0])
    b = int(np.argmin(np.where(fs.clones.valid & (np.arange(C) != a), fs.clones.frame, 1 << 30)))
    ref = _np(J_REANCHOR(CFG, fs, jnp.int32(a), jnp.int32(b), jnp.asarray(do)))
    got = tslam.reanchor_on_prune(TCFG, _port(fs), torch.tensor(a), torch.tensor(b), torch.tensor(do))
    assert (int(ref.slam.anchor_slot[0]) != a) == do
    assert_filter_close(got, ref)


@pytest.mark.parametrize("case", ["none", "forced"])
def test_drop_lost(seq, case):
    """Nothing forced, and both slots forced out (slot 0's track lost, slot 1
    failing gating hard): their rows and columns cleared."""
    k = seq["live"][1]
    fs = seq["states"][k].filter
    f, _ = _frame(seq, k - 1)
    hard = np.zeros(S, bool)
    if case == "forced":
        valid = f.valid.copy()
        valid[fs.slam.track_slot[0]] = False
        f = f._replace(valid=valid)
        hard[1] = True
    ref = _np(J_DROP(CFG, fs, f, jnp.asarray(hard)))
    assert int(ref.slam.valid.sum()) == (0 if case == "forced" else S)
    got = tslam.drop_lost(TCFG, _port(fs), _port(f), _t(hard))
    assert_filter_close(got, ref)
    base = tstate.slam_offset(TCFG, 0)
    if case == "forced":
        assert not got.P.numpy()[base:].any() and not got.P.numpy()[:, base:].any()


@pytest.mark.parametrize("offset", [0, 5])
def test_filter_step(seq, offset):
    """One whole dense filter_step from a converted mid-sequence state."""
    k = seq["k"] - offset
    vs = seq["states"][k]
    f, i = _frame(seq, k)
    rj, oj = _np(J_STEP(CFG, vs, f, i))
    rt, ot = tmsckf.filter_step(TCFG, _port(vs), _port(f), _port(i))
    assert_filter_close(rt.filter, rj.filter)
    for name in ("initialized", "stationary", "n_clones", "n_tracks", "n_updated", "n_slam", "did_reset"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    np.testing.assert_allclose(ot.p_std.numpy(), oj.p_std, rtol=2e-3, atol=1e-6)


def test_feature_sequence(seq):
    """Both packages free-running over the 5 s: masks and counts equal on
    every frame, positions within 1e-3 m, every P finite and symmetric."""
    vs = tmsckf.init_vio_state(TCFG, "cpu")
    feats, imu = _port(seq["feats"]), _port(seq["imu"])
    dp = 0.0
    for k, oj in enumerate(seq["outs"]):
        vs, ot = tmsckf.filter_step(TCFG, vs, *(tree_map(lambda a: a[k], x) for x in (feats, imu)))
        for name in ("initialized", "n_clones", "n_slam", "n_updated", "did_reset"):
            assert int(getattr(ot, name)) == int(getattr(oj, name)), (k, name)
        dp = max(dp, float(np.abs(ot.p.numpy() - oj.p).max()))
        P = vs.filter.P
        assert torch.isfinite(P).all(), k
        assert float((P - P.T).abs().max()) <= 1e-5 * float(P.abs().max()), k
    assert dp < 1e-3, dp

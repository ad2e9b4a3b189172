"""Parity of the PyTorch port's filter modules with the JAX package.

A JAX filter runs a few seconds of simulator features (pure-MSCKF, small
window); its mid-sequence states are converted with
``larvio_tpu_torch.convert.from_reference`` and both packages apply each
module's function to the same state and inputs. Tolerances (as
tests/test_filter.py): nominal q, bg, ba, td, extrinsic atol 5e-5, v and p
atol 5e-4; implied covariance P = S S^T within 3e-3 of max|P| (the factor S
is not unique, so S itself is never compared); masks, slots and ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.api import make_frame_inputs
from larvio_tpu.config import FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models import augmentation as jaug
from larvio_tpu.models import initializer as jinit
from larvio_tpu.models import msckf as jmsckf
from larvio_tpu.models import propagation as jprop
from larvio_tpu.models import prune as jprune
from larvio_tpu.models import state as jstate
from larvio_tpu.models import triangulation as jtri
from larvio_tpu.models import update as jupd
from larvio_tpu.models import zupt as jzupt
from larvio_tpu_torch.convert import from_reference, to_reference_numpy
from larvio_tpu_torch.models import augmentation as taug
from larvio_tpu_torch.models import initializer as tinit
from larvio_tpu_torch.models import msckf as tmsckf
from larvio_tpu_torch.models import propagation as tprop
from larvio_tpu_torch.models import prune as tprune
from larvio_tpu_torch.models import state as tstate
from larvio_tpu_torch.models import triangulation as ttri
from larvio_tpu_torch.models import update as tupd
from larvio_tpu_torch.models import zupt as tzupt

torch.set_num_threads(1)

CFG = VioConfig(
    frontend=FrontendConfig(max_features=32),
    filter=FilterConfig(max_slam_features=0, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60, max_update_features=12, max_prune_features=12),
)
D = jstate.state_dim(CFG)


def _jit(fn, **kw):
    """The JAX oracle, compiled once per test module (cfg is static)."""
    return jax.jit(fn, static_argnums=0, **kw)


J_PROPAGATE = _jit(jprop.propagate)
J_REMOVE = _jit(jprune.remove_clones)
J_AUGMENT = _jit(jaug.augment_state)
J_ADD_OBS = _jit(jaug.add_observations)
J_TRIANGULATE = _jit(jtri.triangulate_batch)
J_APPLY = _jit(jupd.apply_update, static_argnames=("refactor",))
J_ZUPT = _jit(jzupt.zupt_update)
J_BLOCKS = _jit(lambda cfg, fs, p, u, m, t: jax.vmap(
    lambda p_, u_, m_, t_: jupd.feature_block(cfg, fs, p_, u_, m_, t_))(p, u, m, t))
J_PRUNE_BLOCKS = _jit(lambda cfg, fs, p, u, s, o, t: jax.vmap(
    lambda p_, u_, o_, t_: jupd.prune_feature_block(cfg, fs, p_, u_, s, o_, t_))(p, u, o, t))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_reference(_np(tree), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def seq():
    """JAX filter over 4 s of noisy simulator features; keeps every state."""
    sim = Simulator(SimConfig(duration=4.0, static_lead_in=1.0, n_landmarks=300, pixel_noise=0.002,
                              gyro_noise=0.005, acc_noise=0.05, seed=3), CFG)
    data = sim.generate()
    feats, imu = make_frame_inputs(data)
    step = jax.jit(jmsckf.filter_step, static_argnums=0)
    vs = jmsckf.init_vio_state(CFG)
    states, outs = [vs], []
    for k in range(data["t_img"].shape[0]):
        f_k = jax.tree.map(lambda a: a[k], feats)
        i_k = jax.tree.map(lambda a: a[k], imu)
        vs, out = step(CFG, vs, f_k, i_k)
        states.append(vs)
        outs.append(out)
    inited = [bool(o.initialized) for o in outs]
    k_mid = len(outs) - 10
    assert inited[k_mid] and sum(inited) > 40
    return dict(states=states, feats=feats, imu=imu, outs=outs, k=k_mid, data=data)


def _inputs(seq, k):
    """Frame k's (FrameFeatures, ImuBatch) for both packages."""
    f = jax.tree.map(lambda a: a[k], seq["feats"])
    i = jax.tree.map(lambda a: a[k], seq["imu"])
    return f, i, _port(f), _port(i)


def assert_filter_close(got, ref):
    """got: port FilterState; ref: JAX FilterState."""
    g, r = to_reference_numpy(got), _np(ref)
    for name in ("q", "bg", "ba", "td", "q_ci", "t_ci", "q_null"):
        np.testing.assert_allclose(g[name], np.asarray(getattr(r, name)), atol=5e-5, err_msg=name)
    for name in ("v", "p", "v_null", "p_null", "time"):
        np.testing.assert_allclose(g[name], np.asarray(getattr(r, name)), atol=5e-4, err_msg=name)
    for name in ("initialized", "stationary", "frame", "reset_count"):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(r, name)), err_msg=name)
    for name in ("valid", "frame"):
        np.testing.assert_array_equal(g["clones"][name], np.asarray(getattr(r.clones, name)), err_msg=name)
    np.testing.assert_allclose(g["clones"]["q"], np.asarray(r.clones.q), atol=5e-5)
    np.testing.assert_allclose(g["clones"]["p"], np.asarray(r.clones.p), atol=5e-4)
    np.testing.assert_array_equal(g["obs"]["valid"], np.asarray(r.obs.valid))
    np.testing.assert_array_equal(g["obs"]["track_id"], np.asarray(r.obs.track_id))
    np.testing.assert_allclose(g["obs"]["uv"], np.asarray(r.obs.uv), atol=1e-6)
    assert_cov_close(g["P"], np.asarray(r.P))


def assert_cov_close(S_got, S_ref):
    P_got = S_got.astype(np.float64) @ S_got.T.astype(np.float64)
    P_ref = S_ref.astype(np.float64) @ S_ref.T.astype(np.float64)
    np.testing.assert_allclose(P_got, P_ref, atol=3e-3 * np.abs(P_ref).max())


def test_convert_round_trip_exact(seq):
    vs = seq["states"][seq["k"]]
    ref = _np(vs)
    back = to_reference_numpy(from_reference(ref, "cpu"))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in flat_ref:
        node = back
        for p in path:
            node = node[getattr(p, "name", getattr(p, "key", None))]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf, equal_nan=True), path


def test_state_init():
    ref = _np(jstate.init_filter_state(CFG))
    got = to_reference_numpy(tstate.init_filter_state(CFG, "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = got
        for p in path:
            node = node[p.name]
        np.testing.assert_allclose(node, leaf, atol=1e-7, err_msg=str(path))
    for mode in ("static", "dynamic"):
        np.testing.assert_array_equal(tstate.initial_covariance(CFG, torch.device("cpu"), mode=mode).numpy(),
                                      np.asarray(jstate.initial_covariance(CFG, mode=mode)))
    S = np.random.default_rng(0).normal(size=(D, D + 15)).astype(np.float32)
    np.testing.assert_allclose(tstate.cov_diag(CFG, _t(S)).numpy(),
                               np.asarray(jstate.cov_diag(CFG, jnp.asarray(S))), rtol=1e-5)


def test_propagate(seq):
    k = seq["k"]
    fs = seq["states"][k].filter
    f, i, _, ti = _inputs(seq, k)
    ref = J_PROPAGATE(CFG, fs, i, f.t)
    got = tprop.propagate(CFG, _port(fs), ti, torch.tensor(np.asarray(f.t)))
    assert got.P.shape == ref.P.shape  # the wide (D, D+15) factor
    assert_filter_close(got, ref)


def test_initializer(seq):
    acc_j = jinit.InitAccumulator.zero()
    acc_t = tinit.InitAccumulator.zero("cpu")
    fs_j, fs_t = seq["states"][0].filter, _port(seq["states"][0].filter)
    did = []
    for k in range(12):
        f, i, tf, ti = _inputs(seq, k)
        acc_j = jinit.accumulate(acc_j, i, f.mean_motion)
        acc_t = tinit.accumulate(acc_t, ti, tf.mean_motion)
        fs_j, acc_j, dj = jinit.try_static_init(CFG, fs_j, acc_j)
        fs_t, acc_t, dt = tinit.try_static_init(CFG, fs_t, acc_t)
        assert bool(dj) == bool(dt)
        did.append(bool(dt))
        for name in ("sum_w", "sum_a", "sum_a2", "last_t", "sum_motion"):
            np.testing.assert_allclose(getattr(acc_t, name).numpy(), np.asarray(getattr(acc_j, name)), rtol=1e-5)
        assert int(acc_t.count) == int(acc_j.count) and int(acc_t.n_frames) == int(acc_j.n_frames)
    assert any(did)
    assert_filter_close(fs_t, fs_j)
    a = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32) * 3
    a[0] = [0, 0, 9.81]
    for v in a:
        np.testing.assert_allclose(tinit.gravity_aligned_quat(_t(v)).numpy(),
                                   np.asarray(jinit.gravity_aligned_quat(jnp.asarray(v))), atol=1e-6)


def test_augmentation(seq):
    k = seq["k"]
    vs = seq["states"][k]
    f, i, tf, ti = _inputs(seq, k)
    fs_j = J_PROPAGATE(CFG, vs.filter, i, f.t)
    fs_j = J_REMOVE(CFG, fs_j, jnp.int32(0), jnp.int32(1), jnp.asarray(True))
    fs_t = _port(fs_j)
    w = np.asarray(i.w[-1]) - np.asarray(fs_j.bg)
    for do in (True, False):
        rj, sj = J_AUGMENT(CFG, fs_j, jnp.asarray(do), jnp.asarray(w))
        rt, st = taug.augment_state(CFG, fs_t, torch.tensor(do), _t(w))
        assert int(sj) == int(st)
        assert_filter_close(rt, rj)
        oj = J_ADD_OBS(CFG, rj, sj, f.ids, f.uv, f.valid)
        ot = taug.add_observations(CFG, rt, st, tf.ids, tf.uv, tf.valid)
        assert_filter_close(ot, oj)


def _tri_batch(seq):
    fs = seq["states"][seq["k"]].filter
    mask = np.asarray(fs.obs.valid)
    return fs, np.asarray(fs.obs.uv), mask


def test_triangulation(seq):
    fs, uv, mask = _tri_batch(seq)
    cams = jtri.camera_window(fs)
    ref = J_TRIANGULATE(CFG, cams, fs.clones.frame, jnp.asarray(uv), jnp.asarray(mask))
    fs_t = _port(fs)
    got = ttri.triangulate_batch(CFG, ttri.camera_window(fs_t), fs_t.clones.frame,
                                 _t(uv), _t(mask))
    cw_t, cw_j = ttri.camera_window(fs_t), cams
    np.testing.assert_allclose(cw_t.R_cw.numpy(), np.asarray(cw_j.R_cw), atol=1e-6)
    np.testing.assert_allclose(cw_t.p_cw.numpy(), np.asarray(cw_j.p_cw), atol=1e-5)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.anchor.numpy(), np.asarray(ref.anchor))
    assert v.sum() >= 5
    np.testing.assert_allclose(got.p_w.numpy()[v], np.asarray(ref.p_w)[v], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.mean_err.numpy()[v], np.asarray(ref.mean_err)[v], rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got.resid.numpy()[v], np.asarray(ref.resid)[v], atol=1e-4)


def test_prune(seq):
    # the last state with a full window (pruning happens every frame then)
    for vs in seq["states"][::-1]:
        if int(np.sum(np.asarray(vs.filter.clones.valid))) == CFG.filter.max_clones:
            break
    fs = vs.filter
    aj, bj = jprune.select_redundant(CFG, fs)
    fs_t = _port(fs)
    at, bt = tprune.select_redundant(CFG, fs_t)
    assert (int(at), int(bt)) == (int(aj), int(bj))
    for do in (True, False):
        rj = J_REMOVE(CFG, fs, aj, bj, jnp.asarray(do))
        rt = tprune.remove_clones(CFG, fs_t, at, bt, torch.tensor(do))
        assert_filter_close(rt, rj)


def test_zupt(seq):
    k = seq["k"]
    fs = seq["states"][k + 1].filter
    f, i, tf, ti = _inputs(seq, k)
    for mm_ in (1e-4, 1e-2):
        sj = jzupt.detect_stationary(CFG, jnp.float32(mm_), jnp.int32(20), fs, i)
        st = tzupt.detect_stationary(CFG, torch.tensor(mm_, dtype=torch.float32), torch.tensor(20), _port(fs), ti)
        assert bool(sj) == bool(st)
    for stationary in (True, False):
        rj = J_ZUPT(CFG, fs, jnp.asarray(stationary))
        rt = tzupt.zupt_update(CFG, _port(fs), torch.tensor(stationary))
        assert_filter_close(rt, rj)


def test_update_blocks_and_apply(seq):
    """feature_block / prune_feature_block on the window's live rows, then one
    stacked apply_update (the Gram path) and a 9-row sqrt_update."""
    k = seq["k"]
    fs = seq["states"][k].filter
    f, i, _, _ = _inputs(seq, k)
    fs = J_PROPAGATE(CFG, fs, i, f.t)  # wide factor, as in the frame step
    fs_t = _port(fs)
    uv, mask = np.asarray(fs.obs.uv), np.asarray(fs.obs.valid)
    tri = J_TRIANGULATE(CFG, jtri.camera_window(fs), fs.clones.frame, jnp.asarray(uv), jnp.asarray(mask))
    p_w, tv = np.asarray(tri.p_w), np.asarray(tri.valid)
    ref = J_BLOCKS(CFG, fs, jnp.asarray(p_w), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(tv))
    got = tupd.feature_block(CFG, fs_t, _t(p_w), _t(uv),
                             _t(mask), _t(tv))
    acc = np.asarray(ref.accept)
    np.testing.assert_array_equal(got.accept.numpy(), acc)
    assert acc.sum() >= 3
    Hg, rg = got.H.numpy().astype(np.float64), got.r.numpy().astype(np.float64)
    Hr, rr = np.asarray(ref.H, np.float64), np.asarray(ref.r, np.float64)
    Ig, Ir = np.einsum("kij,kil->jl", Hg, Hg), np.einsum("kij,kil->jl", Hr, Hr)
    np.testing.assert_allclose(Ig, Ir, atol=1e-3 * np.abs(Ir).max())
    np.testing.assert_allclose(np.einsum("kij,ki->j", Hg, rg), np.einsum("kij,ki->j", Hr, rr),
                               atol=1e-3 * np.abs(Ir).max() ** 0.5)

    slots = jnp.asarray([0, 1], jnp.int32)
    ok2 = mask[:, :2]
    ref_p = J_PRUNE_BLOCKS(CFG, fs, jnp.asarray(p_w), jnp.asarray(uv[:, :2]), slots, jnp.asarray(ok2),
                           jnp.asarray(tv))
    got_p = tupd.prune_feature_block(CFG, fs_t, _t(p_w), _t(uv[:, :2]),
                                     torch.tensor([0, 1]), _t(ok2), _t(tv))
    np.testing.assert_array_equal(got_p[2].numpy(), np.asarray(ref_p[2]))
    Hp_g, Hp_r = got_p[0].numpy().astype(np.float64), np.asarray(ref_p[0], np.float64)
    np.testing.assert_allclose(Hp_g.T @ Hp_g, Hp_r.T @ Hp_r, atol=1e-3 * max(np.abs(Hp_r.T @ Hp_r).max(), 1e-12))

    H = np.concatenate([np.asarray(ref.H).reshape(-1, D), np.asarray(ref_p[0])])
    r = np.concatenate([np.asarray(ref.r).reshape(-1), np.asarray(ref_p[1])])
    assert H.shape[0] > D  # the Gram (Woodbury) path
    obs_var = jnp.float32(CFG.noise.observation_noise**2)
    for enable in (True, False):
        rj, dxj, okj = J_APPLY(CFG, fs, jnp.asarray(H), jnp.asarray(r), obs_var,
                               enable=jnp.asarray(enable), refactor=True)
        rt, dxt, okt = tupd.apply_update(CFG, fs_t, _t(H), _t(r),
                                         torch.tensor(float(obs_var)), enable=torch.tensor(enable), refactor=True)
        assert bool(okj) == bool(okt)
        np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), atol=5e-5)
        assert_filter_close(rt, rj)

    # small system (n <= D): the stacked-Joseph sqrt_update on the square factor
    Sq = np.asarray(jax.jit(jupd.psd_factor)(fs.P))
    Hs = np.random.default_rng(2).normal(size=(9, D)).astype(np.float32) * 0.5
    rs = np.random.default_rng(3).normal(size=9).astype(np.float32) * 0.01
    dj, Sj = jax.jit(jupd.sqrt_update)(jnp.asarray(Sq), jnp.asarray(Hs), jnp.asarray(rs))
    dt, St = tupd.sqrt_update(_t(Sq), _t(Hs), _t(rs))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=5e-5)
    assert_cov_close(St.numpy(), np.asarray(Sj))
    dj, Sj = jax.jit(jupd.sqrt_update_gram, static_argnames=("refactor",))(
        fs.P, jnp.asarray(H) / 0.035, jnp.asarray(r) / 0.035, refactor=True)
    dt, St = tupd.sqrt_update_gram(fs_t.P, _t(H) / 0.035, _t(r) / 0.035, refactor=True)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=5e-5)
    assert_cov_close(St.numpy(), np.asarray(Sj))


def test_inject_error(seq):
    fs = seq["states"][seq["k"]].filter
    dx = (np.random.default_rng(4).normal(size=D) * 1e-3).astype(np.float32)
    assert_filter_close(tupd.inject_error(CFG, _port(fs), _t(dx)),
                        jupd.inject_error(CFG, fs, jnp.asarray(dx)))


@pytest.mark.parametrize("offset", [0, 5])
def test_filter_step(seq, offset):
    """One whole filter_step from a converted mid-sequence state."""
    k = seq["k"] - offset
    vs = seq["states"][k]
    f, i, tf, ti = _inputs(seq, k)
    rj, oj = jax.jit(jmsckf.filter_step, static_argnums=0)(CFG, vs, f, i)
    rt, ot = tmsckf.filter_step(CFG, _port(vs), tf, ti)
    assert_filter_close(rt.filter, rj.filter)
    for name in ("initialized", "stationary", "n_clones", "n_tracks", "n_updated", "did_reset"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    np.testing.assert_allclose(ot.p_std.numpy(), np.asarray(oj.p_std), rtol=2e-3, atol=1e-6)

"""Parity of the PyTorch port's hybrid SLAM update with the JAX package.

One small hybrid configuration (F = 32 feature slots, C = 6 clones, S = 3
SLAM slots, a 320x240 camera with scaled intrinsics) serves every test; both
packages' configs come from one dict (``convert.config_from_dict``). A JAX
filter runs 5 s of simulator features; its mid-sequence states, which hold
live SLAM slots, are converted with ``from_reference`` and each ported
function is held against its JAX counterpart (jitted once) on the same
state and inputs.

Tolerances (as tests/test_torch_filter.py): q, bg, ba, td, extrinsic atol
5e-5; v, p, idp atol 5e-4; implied covariance P = S S^T within 3e-3 of
max|P| (S itself is not unique); masks, slots, ids, ``anchor_slot``,
``track_slot`` and ``age`` exact. SLAM measurement rows within 1e-4 of
their largest entry; the consumed windows' eliminated rows (Rf, H3) within
1e-3 of theirs (three Householder reflections of near-degenerate depth
columns); residuals atol 1e-5; triangulated points rtol and atol 1e-3 (as
the triangulation test of tests/test_torch_filter.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.pipeline as jpipe
from larvio_tpu.api import make_frame_inputs
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models import msckf as jmsckf
from larvio_tpu.models import propagation as jprop
from larvio_tpu.models import slam as jslam
from larvio_tpu.models import state as jstate
from larvio_tpu.models import update as jupd
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.models import msckf as tmsckf
from larvio_tpu_torch.models import propagation as tprop
from larvio_tpu_torch.models import slam as tslam
from larvio_tpu_torch.models import state as tstate
from larvio_tpu_torch.models import triangulation as ttri
from larvio_tpu_torch.models import update as tupd
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.parallel import fleet as tfleet
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=32),
    filter=FilterConfig(max_slam_features=3, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60, max_update_features=12, max_prune_features=12,
                        slam_promote_obs=5),
)
TCFG = config_from_dict(dataclasses.asdict(CFG))
S, C, F = 3, 6, 32
D = jstate.state_dim(CFG)
assert CFG.filter.bootstrap_consume_k <= F  # the JAX oracle's top_k needs it


def _variant(**kw):
    """(JAX config, port config) with some filter options changed."""
    cfg = dataclasses.replace(CFG, filter=dataclasses.replace(CFG.filter, **kw))
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def _jit(fn, **kw):
    """The JAX oracle, compiled once per test module (cfg is static)."""
    return jax.jit(fn, static_argnums=0, **kw)


J_STEP = _jit(jmsckf.filter_step)
J_OWNED = _jit(jslam.slam_owned_rows)
J_WORLD = _jit(jslam.slam_world_points, static_argnames=("fej",))
J_MEAS = _jit(jslam.slam_measurement_blocks)
J_CONSUME = _jit(jmsckf._consume_blocks)
J_APPLY = _jit(jupd.apply_update, static_argnames=("refactor",))
J_PROMOTE = _jit(jslam.promote_features)
J_REANCHOR = _jit(jslam.reanchor_on_prune)
J_RELIN = _jit(jslam.relinearize_nulls)
J_DROP = _jit(jslam.drop_lost)
J_PROPAGATE = _jit(jprop.propagate)
J_INJECT = _jit(jupd.inject_error)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree, device="cpu"):
    return from_reference(_np(tree), device)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _sim_frames(cfg, seed, duration=5.0):
    sim = Simulator(SimConfig(duration=duration, static_lead_in=1.0, n_landmarks=300, pixel_noise=0.002,
                              gyro_noise=0.005, acc_noise=0.05, seed=seed), cfg)
    return _np(make_frame_inputs(sim.generate()))


@pytest.fixture(scope="module")
def seq():
    """JAX filter over 5 s of noisy simulator features; keeps every state:
    states[k] is the state before frame k."""
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
    promotes = [k for k in range(len(outs)) if n_slam[k] > n_live[k] and n_live[k] > 0]
    live = [k for k in range(40, len(outs)) if n_live[k] == S and n_live[k - 1] == S]
    assert promotes and len(live) >= 3
    return dict(states=states, outs=outs, feats=feats, imu=imu, promotes=promotes, live=live)


def _frame(seq, k):
    """Frame k's (FrameFeatures, ImuBatch) as numpy trees."""
    return jax.tree.map(lambda a: a[k], seq["feats"]), jax.tree.map(lambda a: a[k], seq["imu"])


def _newest(fs):
    return int(np.argmax(np.where(fs.clones.valid, fs.clones.frame, -1)))


def assert_slam_close(g, r):
    """g: the port's SLAM leaves (numpy dict); r: the JAX SlamFeatures."""
    for name in ("valid", "anchor_slot", "track_slot", "track_id", "age"):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(r, name)), err_msg=name)
    for name in ("idp", "idp_null"):
        np.testing.assert_allclose(g[name], np.asarray(getattr(r, name)), atol=5e-4, err_msg=name)


def assert_cov_close(S_got, S_ref):
    P_got = S_got.astype(np.float64) @ S_got.T.astype(np.float64)
    P_ref = S_ref.astype(np.float64) @ S_ref.T.astype(np.float64)
    np.testing.assert_allclose(P_got, P_ref, atol=3e-3 * np.abs(P_ref).max())


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
    assert_slam_close(g["slam"], ref.slam)
    assert g["P"].shape == np.asarray(ref.P).shape
    assert_cov_close(g["P"], np.asarray(ref.P))


def test_convert_round_trip_with_live_slam_slots(seq):
    """A JAX state with live SLAM slots converts to the port and back bit for bit."""
    ref = seq["states"][seq["live"][0]]
    assert ref.filter.slam.valid.all()
    back = to_reference_numpy(from_reference(ref, "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = back
        for p in path:
            node = node[p.name]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf), path


def test_geometry_and_owned_rows(seq):
    fs = seq["states"][seq["live"][0]].filter
    ft = _port(fs)
    owned = np.asarray(J_OWNED(CFG, fs))
    assert owned.sum() == S
    np.testing.assert_array_equal(tslam.slam_owned_rows(TCFG, ft).numpy(), owned)
    for fej in (False, True):
        np.testing.assert_allclose(tslam.slam_world_points(TCFG, ft, fej=fej).numpy(),
                                   np.asarray(J_WORLD(CFG, fs, fej=fej)), atol=5e-4)
    assert tstate.slam_offset(TCFG, 2) == jstate.slam_offset(CFG, 2) == D - 3


@pytest.mark.parametrize("which", [0, 1, 2])
def test_slam_measurement_blocks(seq, which):
    """The 2-row SLAM update of a state with three live features against the
    features of the frame that made its newest clone."""
    k = seq["live"][which * (len(seq["live"]) - 1) // 2]
    fs = seq["states"][k].filter
    f, _ = _frame(seq, k - 1)
    Hj, rj, aj, hj = _np(J_MEAS(CFG, fs, f, jnp.int32(_newest(fs))))
    Ht, rt, at, ht = tslam.slam_measurement_blocks(TCFG, _port(fs), _port(f), torch.tensor(_newest(fs)))
    assert aj.sum() >= 1
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    assert Ht.shape == (2 * S, D)
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)


def _candidates(fs):
    """Every live row that no SLAM feature owns."""
    return np.asarray(fs.obs.track_id >= 0) & ~np.asarray(J_OWNED(CFG, fs))


def _consume_frame(seq):
    """The first live-state frame whose wide consume channel accepts >= 2
    windows (the JAX oracle's verdict)."""
    for k in seq["live"]:
        fs = seq["states"][k].filter
        sel = J_CONSUME(CFG, fs, jnp.asarray(_candidates(fs)), jnp.asarray(True))[4]
        if int(np.sum(sel)) >= 2:
            return k
    raise AssertionError("no live state consumes two windows")


@pytest.mark.parametrize("wide", [False, True])
def test_consume_blocks(seq, wide):
    fs = seq["states"][_consume_frame(seq)].filter
    cand = _candidates(fs)
    bj, cj, ij, tj, sj = _np(J_CONSUME(CFG, fs, jnp.asarray(cand), jnp.asarray(wide)))
    bt, ct, it, tt, st = tmsckf._consume_blocks(TCFG, _port(fs), _t(cand), torch.tensor(wide))
    assert it.shape == ij.shape == (max(S, CFG.filter.bootstrap_consume_k),)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(bt.accept.numpy(), bj.accept)
    assert sj.sum() >= (2 if wide else 1)
    np.testing.assert_allclose(tt.p_w.numpy()[sj], tj.p_w[sj], rtol=1e-3, atol=1e-3)
    Hg, Hr = bt.H.numpy().astype(np.float64), bj.H.astype(np.float64)
    Ig, Ir = np.einsum("kij,kil->jl", Hg, Hg), np.einsum("kij,kil->jl", Hr, Hr)
    np.testing.assert_allclose(Ig, Ir, atol=1e-3 * np.abs(Ir).max())
    for name in ("Rf", "H3"):
        a, b = getattr(bt, name).numpy()[sj], getattr(bj, name)[sj]
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max(), err_msg=name)
    np.testing.assert_allclose(bt.r3.numpy()[sj], bj.r3[sj], atol=1e-5)


@pytest.mark.parametrize("k_rho", [0.0, 2.0])
def test_promote_features(seq, k_rho):
    """Consume -> hybrid apply_update -> promote into two freed slots, from
    one JAX state; the port's promote_features on the converted inputs."""
    # the inflated rho variance needs a looser promotion gate to pass it
    jcfg, tcfg = (CFG, TCFG) if k_rho == 0.0 else _variant(slam_init_rho_inflation=k_rho,
                                                           slam_max_init_rho_sigma=3.0)
    k = _consume_frame(seq)
    fs = seq["states"][k].filter
    f, _ = _frame(seq, k - 1)
    fs = _np(J_DROP(CFG, fs, jax.tree.map(jnp.asarray, f), jnp.arange(S) >= 1))
    assert int(fs.slam.valid.sum()) == 1
    cand = _candidates(fs)
    blocks, _, idx, tri, sel = J_CONSUME(CFG, fs, jnp.asarray(cand), jnp.asarray(True))
    H = blocks.H.reshape(-1, D)
    fs2, dx, ok = J_APPLY(CFG, fs, H, blocks.r.reshape(-1), jnp.float32(CFG.noise.observation_noise**2),
                          enable=jnp.asarray(True))
    assert bool(ok)
    anchor = jnp.int32(_newest(fs))
    ref = _np(J_PROMOTE(jcfg, fs2, blocks, tri, idx, sel, dx, anchor))
    assert int(ref.slam.valid.sum()) == S  # two promotions into the freed slots
    got = tslam.promote_features(
        tcfg, _port(fs2), tupd.FeatureBlock(*(_t(x) for x in _np(blocks))),
        ttri.TriangulationResult(*(_t(x) for x in _np(tri))), _t(idx), _t(sel), _t(dx),
        torch.tensor(int(anchor)))
    assert_filter_close(got, ref)


@pytest.mark.parametrize("factor", ["square", "wide"])
def test_reanchor_on_prune(seq, factor):
    """A forced prune of the clone that anchors the SLAM features, on the
    square factor and on the propagation-wide (D, D+15) one."""
    k = seq["live"][len(seq["live"]) // 2]
    fs = seq["states"][k].filter
    if factor == "wide":
        f, i = _frame(seq, k)
        fs = _np(J_PROPAGATE(CFG, fs, i, f.t))
        assert fs.P.shape == (D, D + 15)
    a = int(fs.slam.anchor_slot[0])
    b = int(np.argmin(np.where(fs.clones.valid & (np.arange(C) != a), fs.clones.frame, 1 << 30)))
    for do in (True, False):
        ref = _np(J_REANCHOR(CFG, fs, jnp.int32(a), jnp.int32(b), jnp.asarray(do)))
        got = tslam.reanchor_on_prune(TCFG, _port(fs), torch.tensor(a), torch.tensor(b), torch.tensor(do))
        assert (int(ref.slam.anchor_slot[0]) != a) == do
        assert_filter_close(got, ref)


def test_relinearize_nulls(seq):
    jcfg, tcfg = _variant(slam_relin_sigma=1.0)
    fs = seq["states"][seq["live"][0]].filter
    null = fs.slam.idp_null.copy()
    null[0, 0] += 0.05  # far outside slot 0's trust region
    fs = fs.replace(slam=fs.slam.replace(idp_null=null))
    ref = _np(J_RELIN(jcfg, fs))
    assert np.array_equal(ref.slam.idp_null[0], fs.slam.idp[0])
    got = tslam.relinearize_nulls(tcfg, _port(fs))
    np.testing.assert_array_equal(got.slam.idp_null.numpy(), ref.slam.idp_null)


@pytest.mark.parametrize("case", ["none", "forced"])
def test_drop_lost(seq, case):
    """Nothing forced, and every cause at once: slot 0's track lost, slot 1
    failing gating hard, slot 2 at the end of its lifetime."""
    k = seq["live"][1]
    fs = seq["states"][k].filter
    f, _ = _frame(seq, k - 1)
    hard = np.zeros(S, bool)
    if case == "forced":
        valid = f.valid.copy()
        valid[fs.slam.track_slot[0]] = False
        f = f._replace(valid=valid)
        hard[1] = True
        age = fs.slam.age.copy()
        age[2] = CFG.filter.slam_max_lifetime
        fs = fs.replace(slam=fs.slam.replace(age=age))
    ref = _np(J_DROP(CFG, fs, f, jnp.asarray(hard)))
    assert int(ref.slam.valid.sum()) == (0 if case == "forced" else S)
    got = tslam.drop_lost(TCFG, _port(fs), _port(f), _t(hard))
    assert_filter_close(got, ref)
    dropped = ~ref.slam.valid
    rows = np.asarray(got.P)[D - 3 * S:].reshape(S, 3, -1)
    assert not rows[dropped].any()


def test_propagate_with_slam_process_noise(seq):
    jcfg, tcfg = _variant(slam_process_noise=0.05)
    k = seq["live"][0]
    fs = seq["states"][k].filter
    f, i = _frame(seq, k)
    ref = _np(J_PROPAGATE(jcfg, fs, i, f.t))
    got = tprop.propagate(tcfg, _port(fs), _port(i), _t(f.t))
    assert got.P.shape == ref.P.shape == (D, D + 15 + 3 * S)
    assert_filter_close(got, ref)


def test_inject_error_moves_valid_slam_slots_only(seq):
    fs = seq["states"][seq["live"][0]].filter
    valid = fs.slam.valid.copy()
    valid[1] = False
    fs = fs.replace(slam=fs.slam.replace(valid=valid))
    dx = (np.random.default_rng(4).normal(size=D) * 1e-3).astype(np.float32)
    ref = _np(J_INJECT(CFG, fs, jnp.asarray(dx)))
    got = tupd.inject_error(TCFG, _port(fs), _t(dx))
    assert_filter_close(got, ref)
    np.testing.assert_array_equal(got.slam.idp[1].numpy(), fs.slam.idp[1])
    assert not np.array_equal(ref.slam.idp[0], fs.slam.idp[0])


@pytest.mark.parametrize("which", ["promote", "live_early", "live_late"])
def test_filter_step(seq, which):
    """One whole hybrid filter_step from a converted mid-sequence state,
    including a frame that promotes."""
    k = {"promote": seq["promotes"][-1], "live_early": seq["live"][0], "live_late": seq["live"][-1]}[which]
    vs = seq["states"][k]
    f, i = _frame(seq, k)
    rj, oj = _np(J_STEP(CFG, vs, f, i))
    rt, ot = tmsckf.filter_step(TCFG, _port(vs), _port(f), _port(i))
    assert_filter_close(rt.filter, rj.filter)
    for name in ("initialized", "stationary", "n_clones", "n_tracks", "n_updated", "n_slam", "did_reset"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    if which == "promote":
        assert int(oj.n_slam) > int(vs.filter.slam.valid.sum())


def test_consume_width_clamped_to_the_table():
    """Port deviation: with fewer feature slots than bootstrap_consume_k the
    port clamps the consume width (the JAX package's top_k raises) and a
    hybrid run stays finite."""
    jcfg = VioConfig(camera=CFG.camera, frontend=FrontendConfig(max_features=8),
                     filter=dataclasses.replace(CFG.filter, bootstrap_consume_k=12))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    fs0 = jstate.init_filter_state(jcfg)
    with pytest.raises(Exception):
        jmsckf._consume_blocks(jcfg, fs0, jnp.ones(8, bool))
    _, _, idx, _, _ = tmsckf._consume_blocks(tcfg, tstate.init_filter_state(tcfg, "cpu"),
                                             torch.ones(8, dtype=torch.bool), torch.tensor(True))
    assert idx.shape == (8,)
    feats, imu = _sim_frames(jcfg, 5, duration=4.0)
    _, outs = tfleet.run_fleet_sequence(tcfg, tmsckf.init_vio_state(tcfg, "cpu"), _port(feats), _port(imu))
    assert outs.initialized.sum() >= 40
    for name in ("p", "q", "v", "p_std"):
        assert torch.isfinite(getattr(outs, name)).all(), name


@pytest.fixture(scope="module")
def fleet():
    """3 lanes (a simulator seed each) through the port's hybrid fleet, and
    each lane alone through the single-instance step."""
    lanes = [_sim_frames(CFG, seed) for seed in (3, 7, 11)]
    feats = _port(jax.tree.map(lambda *xs: np.stack(xs, axis=1), *[x[0] for x in lanes]))
    imu = _port(jax.tree.map(lambda *xs: np.stack(xs, axis=1), *[x[1] for x in lanes]))
    vs, outs = tfleet.run_fleet_sequence(TCFG, tfleet.init_fleet_state(TCFG, 3, "cpu"), feats, imu)
    singles = [tfleet.run_fleet_sequence(TCFG, tmsckf.init_vio_state(TCFG, "cpu"), _port(x[0]), _port(x[1]))
               for x in lanes]
    return dict(feats=feats, imu=imu, vs=vs, outs=outs, singles=singles)


def test_hybrid_fleet_equals_single_runs(fleet):
    outs = fleet["outs"]
    for b, (vs1, o1) in enumerate(fleet["singles"]):
        assert o1.n_slam.max() == S, b
        for name in ("initialized", "did_reset", "n_slam", "n_updated"):
            assert torch.equal(getattr(outs, name)[:, b], getattr(o1, name)), (b, name)
        np.testing.assert_allclose(outs.p[:, b].numpy(), o1.p.numpy(), atol=1e-4)
        for name in ("valid", "anchor_slot", "track_id"):
            assert torch.equal(getattr(fleet["vs"].filter.slam, name)[b], getattr(vs1.filter.slam, name))


def test_nan_lane_leaves_other_lanes_slam_state_bit_identical(fleet):
    """Lane 1 gets NaN accelerometer samples for 1 s: it resets, stays finite
    and holds no SLAM slot on its reset frames; lanes 0 and 2, SLAM state
    included, are bit-identical to the clean fleet run."""
    a = fleet["imu"].a.clone()
    a[50:70, 1] = torch.nan
    steps = []
    vs = tfleet.init_fleet_state(TCFG, 3, "cpu")
    clean_vs = tfleet.init_fleet_state(TCFG, 3, "cpu")
    T = a.shape[0]
    for k in range(T):
        f = tree_map(lambda x: x[k], fleet["feats"])
        i = tree_map(lambda x: x[k], fleet["imu"])
        vs, out = tmsckf.filter_step(TCFG, vs, f, i.replace(a=a[k]))
        clean_vs, _ = tmsckf.filter_step(TCFG, clean_vs, f, i)
        for lane in (0, 2):
            for name in ("idp", "idp_null", "valid", "anchor_slot", "track_slot", "track_id", "age"):
                assert torch.equal(getattr(vs.filter.slam, name)[lane], getattr(clean_vs.filter.slam, name)[lane])
            assert torch.equal(vs.filter.P[lane], clean_vs.filter.P[lane])
            assert torch.equal(vs.filter.p[lane], clean_vs.filter.p[lane])
        if out.did_reset[1]:
            assert not vs.filter.slam.valid[1].any()
        steps.append(out)
    resets = torch.stack([o.did_reset[1] for o in steps])
    assert resets.sum() >= 1
    assert torch.isfinite(vs.filter.P[1]).all() and torch.isfinite(vs.filter.p[1]).all()


def test_image_level_hybrid_run_matches_jax():
    """60 rendered frames at the 320x240 camera through the JAX package's
    jitted pipeline_step and the port's, from the same initial state."""
    sim = Simulator(SimConfig(duration=3.0, static_lead_in=1.0), CFG)
    data = sim.generate()
    imgs = np.asarray(jrender_sequence(CFG, sim, data["t_img"]))
    step = jax.jit(jpipe.pipeline_step, static_argnums=0)
    ps_j, ps_t = jpipe.init_pipeline_state(CFG), init_pipeline_state(TCFG, "cpu")
    same_ids, p_j, p_t, slam_j, slam_t = [], [], [], [], []
    for k in range(imgs.shape[0]):
        imu = {n: data[n][k] for n in ("imu_t", "imu_w", "imu_a", "imu_valid")}
        ps_j, oj = step(CFG, ps_j, jpipe.FrameInput(
            image=jnp.asarray(imgs[k]), t=jnp.asarray(data["t_img"][k]),
            imu=JImuBatch(t=jnp.asarray(imu["imu_t"]), w=jnp.asarray(imu["imu_w"]),
                          a=jnp.asarray(imu["imu_a"]), valid=jnp.asarray(imu["imu_valid"]))))
        ps_t, ot = pipeline_step(TCFG, ps_t, FrameInput(
            image=_t(imgs[k]), t=_t(data["t_img"][k]),
            imu=ImuBatch(t=_t(imu["imu_t"]), w=_t(imu["imu_w"]), a=_t(imu["imu_a"]),
                         valid=_t(imu["imu_valid"]))))
        same_ids.append(np.mean(ps_t.tracker.ids.numpy() == np.asarray(ps_j.tracker.ids)))
        p_j.append(np.asarray(oj.p))
        p_t.append(ot.p.numpy())
        slam_j.append(int(oj.n_slam))
        slam_t.append(int(ot.n_slam))
    assert np.mean(same_ids) >= 0.98
    assert max(slam_j) >= 1  # the hybrid update engaged
    assert np.mean(np.array(slam_j) == np.array(slam_t)) >= 0.95
    assert np.abs(np.array(p_t) - np.array(p_j)).max() < 0.01

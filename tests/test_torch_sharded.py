"""The port's sharded fleet (``parallel/fleet.py::make_sharded_fleet``,
``make_sharded_fleet_run``; ``parallel/multichip.py``) on the CPU, against
the one-process fleet and against the JAX package's ``shard_map`` fleet.

Workload: the JAX dry run's (``__graft_entry__.py``): the default clone
window and SLAM block (D = 160) with a 24-slot feature table, 14 IMU slots,
update and prune batches of 8, the static initializer at 60 samples; 4
lanes, each its own noisy 4 s simulator run (seeds 1000 + b). Both
packages' configurations come from one dict (``convert.config_from_dict``).

Tolerances:
- 2 ``gloo`` ranks of 2 lanes each against the one-process fleet of 4
  lanes: every output of every lane bit for bit (the lanes never interact,
  and the CPU's batched ops round each lane the same at any batch width);
  the reduced metrics equal the host sums on every rank;
- against the JAX package's ``make_sharded_fleet_run`` on a 2-device mesh:
  ``initialized`` / ``did_reset`` exact, positions within 1e-3 m (the
  filter fleet's bar, ``tests/test_torch_fleet.py``); one ``step_fn`` frame's
  reduced metrics equal the JAX ``make_sharded_fleet`` psum exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import larvio_tpu.api as japi
import larvio_tpu.config as jconfig
from larvio_tpu.data import sim as jsim
from larvio_tpu.parallel import fleet as jfleet
from larvio_tpu_torch.api import make_frame_inputs
from larvio_tpu_torch.convert import config_from_dict
from larvio_tpu_torch.parallel import fleet as tfleet
from larvio_tpu_torch.parallel import multichip

torch.set_num_threads(1)

# __graft_entry__.py:154-160, the JAX dry run's configuration
J_CFG = jconfig.VioConfig(
    filter=jconfig.FilterConfig(max_update_features=8, max_prune_features=8,
                                imu_slots_per_frame=14, static_init_samples=60),
    frontend=jconfig.FrontendConfig(max_features=24),
)
CFG = config_from_dict(dataclasses.asdict(J_CFG))
N_RANKS, B = 2, 4


@pytest.fixture(scope="module")
def sharded():
    """The dry run on 2 gloo ranks (its own gates hold), and the same 4
    lanes through the one-process fleet."""
    res = multichip.dryrun_multichip(N_RANKS, device="cpu", backend="gloo", cfg=CFG)
    data = multichip.lane_data(CFG, multichip.dryrun_sims(B))
    feats, imu = make_frame_inputs(data, device="cpu")
    vs, outs = tfleet.run_fleet_sequence(CFG, tfleet.init_fleet_state(CFG, B, "cpu"), feats, imu)
    _, step = tfleet.fleet_step(CFG, vs, *make_frame_inputs(data, k=-1, device="cpu"))
    return res, data, outs, step


def test_config_is_the_dry_runs():
    assert CFG == multichip.DRYRUN_CFG


def test_ranks_equal_the_one_process_fleet(sharded):
    res, _, outs, step = sharded
    assert res["backend"] == "gloo" and res["devices"] == ["cpu", "cpu"]
    assert res["p"].shape == (80, B, 3)
    for k in multichip.OUT_KEYS:
        np.testing.assert_array_equal(res[k], getattr(outs, k).numpy(), err_msg=k)
    for k in multichip.STEP_KEYS:
        np.testing.assert_array_equal(res[f"step_{k}"], getattr(step, k).numpy(), err_msg=k)


def test_reduced_metrics_equal_host_sums_on_every_rank(sharded):
    res, _, _, step = sharded
    want = multichip.check_metrics(res)
    assert len(res["metrics"]) == N_RANKS
    assert want == {k: int(v) for k, v in tfleet.fleet_metrics(step).items()}
    assert want["n_initialized"] == B and want["n_resets"] == 0


def test_ranks_match_the_jax_sharded_fleet(sharded):
    """The JAX package's make_sharded_fleet_run on a 2-device CPU mesh, then
    one make_sharded_fleet step on the last frame, on the same lanes."""
    res, data, _, _ = sharded
    jdata = [jsim.Simulator(jsim.SimConfig(**dataclasses.asdict(sc)), J_CFG).generate()
             for sc in multichip.dryrun_sims(B)]
    stacked = {k: np.stack([d[k] for d in jdata], axis=1) for k in jdata[0]}
    for k in data:
        np.testing.assert_array_equal(stacked[k], data[k], err_msg=k)
    mesh = Mesh(np.array(jax.devices("cpu")[:N_RANKS]), ("fleet",))
    init_fn, step_fn = jfleet.make_sharded_fleet(J_CFG, mesh)
    run_fn = jfleet.make_sharded_fleet_run(J_CFG, mesh)
    vs, outs = run_fn(init_fn(B), *japi.make_frame_inputs(stacked))
    _, _, metrics = step_fn(vs, *japi.make_frame_inputs(stacked, k=-1))
    oj = jax.tree.map(np.asarray, outs)
    np.testing.assert_array_equal(res["initialized"], oj.initialized)
    np.testing.assert_array_equal(res["did_reset"], oj.did_reset)
    np.testing.assert_allclose(res["p"], oj.p, atol=1e-3)
    assert res["metrics"][0] == {k: int(v) for k, v in metrics.items()}


def test_lane_blocks_are_the_mesh_shards(monkeypatch):
    """Rank r holds lanes [r B/n, (r+1) B/n), as NamedSharding's blocks on a
    1-D mesh; ``shard_lanes`` cuts a (B, ...) tree on its first axis and a
    (T, B, ...) tree (a dict's leaves too) on its second."""
    assert [tfleet.lane_block(8, 4, r) for r in range(4)] == [slice(0, 2), slice(2, 4),
                                                              slice(4, 6), slice(6, 8)]
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("fleet",))
    x = jax.device_put(np.arange(8), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("fleet")))
    vs = tfleet.init_fleet_state(CFG, 8, "cpu")
    seq = {"t": torch.arange(24.0).reshape(3, 8), "uv": np.zeros((3, 8, 5, 2))}
    for shard in x.addressable_shards:
        r = list(mesh.devices.flat).index(shard.device)
        blk = tfleet.lane_block(8, 4, r)
        np.testing.assert_array_equal(np.asarray(shard.data), np.arange(8)[blk])
        monkeypatch.setattr(tfleet, "_world", lambda group: (4, r))
        mine = tfleet.shard_lanes(vs)
        assert mine.filter.P.shape == (2, *vs.filter.P.shape[1:])
        assert torch.equal(mine.filter.p, vs.filter.p[blk])
        cut = tfleet.shard_lanes(seq, axis=1)
        assert torch.equal(cut["t"], seq["t"][:, blk]) and cut["uv"].shape == (3, 2, 5, 2)


@pytest.mark.parametrize("case", ["indivisible_lanes", "rank_out_of_range", "indivisible_run"])
def test_refuses_lanes_the_ranks_do_not_divide(case):
    with pytest.raises(ValueError):
        if case == "indivisible_lanes":
            tfleet.lane_block(5, 2, 0)
        elif case == "rank_out_of_range":
            tfleet.lane_block(4, 2, 2)
        else:  # before any process starts
            multichip.run_sharded(CFG, multichip.dryrun_sims(3), 2, device="cpu", backend="gloo")


def test_refuses_nccl_without_a_card_per_rank(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        multichip.dryrun_multichip(2, device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        multichip.dryrun_multichip(2, device="cuda", backend="nccl")


def test_refuses_cuda_on_a_host_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        multichip.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="is_available"):
        tfleet.make_sharded_fleet(CFG)
    with pytest.raises(ValueError, match="backend"):
        multichip.dryrun_multichip(2, device="cpu", backend="mpi")

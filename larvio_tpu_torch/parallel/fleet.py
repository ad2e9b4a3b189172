"""A fleet of B independent VIO instances: on one card, and sharded over
the ranks of a ``torch.distributed`` process group (port of
``larvio_tpu/parallel/fleet.py``).

The JAX package vmaps the per-frame step over an instance axis. Here the
instance axis is written out: every leaf of the state, ``FrameFeatures``,
``ImuBatch`` and ``FrameInput`` carries a leading axis B, and the same
``filter_step`` / ``pipeline_step`` that steps one instance steps all B at
once. On the card an image-level fleet frame launches the batched LK kernel
(K3) and the batched describe kernel once each, for all lanes. Lanes never
interact: every reduction runs over one instance's own axes and every select
is per lane, so a reset or a NaN in one lane leaves the others bit-identical.

Sequences are (T, B, ...): time first, instances second, as
``run_fleet_sequence`` in the JAX package.

Across ranks (``make_sharded_fleet``, ``make_sharded_fleet_run``): rank r of
n holds the contiguous lanes [r B/n, (r+1) B/n), the blocks of the JAX
package's ``NamedSharding`` on a 1-D mesh, and steps them as a fleet of its
own. The only collective is one ``all_reduce`` of the three health sums per
step; a whole sequence runs with no communication. Each process holds its
own lanes only: ``shard_lanes`` cuts a rank's block from a (B, ...) or
(T, B, ...) tree. Any backend runs it: ``nccl`` with one card per rank,
``gloo`` on the CPU or with several ranks on one card
(``parallel/multichip.py`` starts the ranks). On ``nccl`` the step with its
``all_reduce`` is replayed as one CUDA graph from ``core/graph.py::CACHE``;
``gloo`` steps eagerly.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from larvio_tpu_torch.api import run_sequence
from larvio_tpu_torch.api import step as api_step
from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.device import resolve_device
from larvio_tpu_torch.core.graph import call
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.models.msckf import StepOutput, VioState, filter_step, init_vio_state
from larvio_tpu_torch.pipeline import PipelineState, init_pipeline_state, run_image_sequence


def _replicate(tree, n: int):
    return tree_map(lambda a: a.expand(n, *a.shape).clone(), tree)


def init_fleet_state(cfg: VioConfig, n_instances: int, device, dtype=torch.float32) -> VioState:
    """Batched VioState: every leaf gains a leading instance axis."""
    return _replicate(init_vio_state(cfg, device, dtype), n_instances)


# One frame of every instance: ``filter_step`` takes the instance axis, so
# the JAX package's name is an alias. (B, ...) state and inputs ->
# (state, StepOutput (B, ...)).
fleet_step = filter_step

# ``fleet_step`` through the cache of captured steps, the JAX package's
# ``jit_fleet_step``: ``api.step`` takes the instance axis (B is part of the
# signature, so each fleet width captures once), so this is an alias.
jit_fleet_step = api_step


# ``filter_step`` over (T, B, ...) inputs: ``api.run_sequence`` takes the
# instance axis, so this is an alias. Returns (final state, StepOutput (T, B, ...)).
run_fleet_sequence = run_sequence


def init_fleet_pipeline_state(cfg: VioConfig, n_instances: int, device,
                              dtype=torch.float32) -> PipelineState:
    """Batched PipelineState (tracker and filter) for an image-level fleet."""
    return _replicate(init_pipeline_state(cfg, device, dtype), n_instances)


# ``pipeline_step`` over (T, B, ...) frames (images (T, B, H, W)), the
# counterpart of the vmapped, scanned step of the JAX package's
# ``bench.py --fleet``: ``run_image_sequence`` takes the instance axis, so
# this is an alias. Returns (final state, StepOutput (T, B, ...)).
run_fleet_image_sequence = run_image_sequence


def fleet_metrics(outs: StepOutput) -> dict:
    """Fleet health summed over the lane axis (the last axis of the per-lane
    scalars), on the device: the single-card counterpart of the JAX package's
    ``psum`` dict. One value per step for a (T, B) sequence, one for a step."""
    return {
        "n_initialized": torch.sum(outs.initialized.to(torch.int32), dim=-1),
        "n_resets": torch.sum(outs.did_reset.to(torch.int32), dim=-1),
        "mean_tracks": torch.sum(outs.n_tracks, dim=-1),
    }


def lane_block(n_instances: int, n_ranks: int, rank: int) -> slice:
    """The lanes that rank ``rank`` of ``n_ranks`` holds: a contiguous block
    of ``n_instances / n_ranks``. Raises unless the ranks divide the lanes."""
    if n_ranks < 1 or not 0 <= rank < n_ranks:
        raise ValueError(f"rank {rank} of {n_ranks}")
    if n_instances % n_ranks:
        raise ValueError(f"{n_instances} instances do not divide over {n_ranks} ranks")
    n = n_instances // n_ranks
    return slice(rank * n, (rank + 1) * n)


def _world(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def shard_lanes(tree, axis: int = 0, group=None):
    """This rank's block of the lanes of ``tree`` (tensors or numpy arrays,
    in dataclasses, tuples, lists or dicts), the instance axis at ``axis``:
    0 for (B, ...), 1 for (T, B, ...). Plain slicing: a view, no gather."""
    n_ranks, rank = _world(group)

    def cut(a):
        blk = lane_block(a.shape[axis], n_ranks, rank)
        return a[(slice(None),) * axis + (blk,)]

    return tree_map(cut, tree)


METRIC_KEYS = ("n_initialized", "n_resets", "mean_tracks")


def make_sharded_fleet(cfg: VioConfig, group=None, device="cuda", graph=None):
    """(init_fn, step_fn) for a fleet sharded over the ranks of ``group``
    (``torch.distributed``'s world by default), each rank on ``device``.

    ``init_fn(n_instances)`` is this rank's block of a fresh fleet of
    ``n_instances`` (raises unless the ranks divide them, as the JAX
    package's ``init_fn`` asserts). ``step_fn(vs, feats, imu)`` steps this
    rank's lanes and returns ``(vs, outs, metrics)``: ``metrics`` holds the
    fleet-wide ``n_initialized``, ``n_resets`` and ``mean_tracks`` (the sum
    of ``n_tracks``), the same 0-d int64 tensors on every rank, from ONE
    ``all_reduce`` of one (3,) tensor on the state's device (the JAX
    package's ``psum``; it waits for every rank's step).

    ``graph`` (the JAX package's jitted ``step_fn``): on an NCCL group on
    the card, None replays ``CACHE``'s capture of ``fleet_step``, the
    metrics and the ``all_reduce`` as one CUDA graph, keyed on ``cfg`` and
    the group, so a new group never replays an old communicator (the
    capture's eager warm-up steps run the first collectives): ``vs`` is
    loaded into the graph's static state and the returned state and outputs
    are copies, equal bit for bit to the eager step. A ``gloo`` group steps
    eagerly, as the CPU does and as False does everywhere."""
    dev = resolve_device(device)
    if graph is None and dist.get_backend(group) != "nccl":
        graph = False  # CUDA graphs hold NCCL collectives only
    entry = ("sharded_fleet_step", cfg, dist.group.WORLD if group is None else group)

    def init_fn(n_instances: int, dtype=torch.float32) -> VioState:
        n_ranks, rank = _world(group)
        blk = lane_block(n_instances, n_ranks, rank)
        return init_fleet_state(cfg, blk.stop - blk.start, dev, dtype)

    def step(vs: VioState, inputs):
        vs, outs = fleet_step(cfg, vs, *inputs)
        local = fleet_metrics(outs)
        sums = torch.stack([local[k].to(torch.int64) for k in METRIC_KEYS])
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        return vs, (outs, sums)

    def step_fn(vs: VioState, feats, imu):
        vs, (outs, sums) = call(entry, step, vs, (feats, imu), graph=graph)
        return vs, outs, dict(zip(METRIC_KEYS, sums.unbind()))

    return init_fn, step_fn


def make_sharded_fleet_run(cfg: VioConfig, group=None):
    """The JAX package's name for ``run_fleet_sequence`` on this rank's lanes:
    ``run_fn(vs, seq_feats, seq_imu) -> (vs, outs)`` with (B/n, ...) state
    and (T, B/n, ...) inputs. A sequence needs no communication, so
    ``group`` is unused."""
    return functools.partial(run_fleet_sequence, cfg)

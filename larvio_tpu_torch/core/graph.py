"""One frame step captured as a CUDA graph and replayed in place: the port's
counterpart of ``jax.jit`` on a step function.

``CapturedStep(fn, state, inputs)`` takes a step ``fn(state, inputs) ->
(state, outputs)`` over trees of CUDA tensors with fixed shapes
(``pipeline_step`` or ``filter_step``, one instance or a fleet) and owns:

* static input buffers, filled by ``replay(inputs)`` before each replay;
* a static state, which every replay advances by one step in place: the
  captured region ends by copying the new state into it leaf by leaf;
* a static output slot, into which every replay writes the step's outputs
  (cloned inside the graph, so an output that is a state or input leaf
  still reads this step's value). ``replay`` returns it; the next replay
  overwrites it, so a caller that keeps outputs copies them first.

Before capture it runs ``warmup`` eager steps on a deep clone of the state
(the caller's state does not advance), on the capture's side stream: that
builds the kernel library, creates the cuBLAS/cuSOLVER handles and
workspaces, and fills every per-device constant cache (``core/device.py``,
``models/frontend.py::_R_ci``, the ORB pattern), whose first use copies from
pageable host memory, which capture forbids.

Kernel pointers are frozen at capture: the kernels read the static input and
state buffers, and intermediates from the graph's private pool, on every
replay. A replay is one launch on the host; the kernel wrappers' counters
tick only while capturing, and ``launches_per_replay`` records what they
counted then, so the launches of a run are ``replays`` times that.

Nothing falls back to eager execution: a CPU device raises, and a failed
capture or replay raises to the caller. Every factorization must run in
cuSOLVER (``core/device.py::card_numerics``): PyTorch's MAGMA paths for
batched factorizations synchronize the host and cannot be captured.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.core.tree import scan as tree_scan

WARMUP_STEPS = 3


def _check_like(dst, src, what: str) -> None:
    d, s = list(leaves(dst)), list(leaves(src))
    if len(d) != len(s):
        raise ValueError(f"{what}: {len(s)} leaves, the captured step has {len(d)}")
    for i, (a, b) in enumerate(zip(d, s)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{what}: leaf {i} is {b.dtype} {tuple(b.shape)}, the captured step "
                             f"holds {a.dtype} {tuple(a.shape)}")


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype)


def copy_into(dst, src) -> None:
    """Copy tree ``src`` into the buffers of tree ``dst`` leaf by leaf.

    A leaf of ``src`` that is its own destination is skipped. A leaf that
    shares storage with any leaf of ``dst`` (a pass-through leaf moved to
    another field, or a view of one) is cloned before any copy, so no copy
    overwrites a source that a later copy still reads."""
    _check_like(dst, src, "copy_into")
    d, s = list(leaves(dst)), list(leaves(src))
    owned = {t.untyped_storage().data_ptr() for t in d}
    srcs = []
    for a, b in zip(d, s):
        if _same_view(a, b):
            srcs.append(None)
        elif b.untyped_storage().data_ptr() in owned:
            srcs.append(b.clone())
        else:
            srcs.append(b)
    for a, b in zip(d, srcs):
        if b is not None:
            a.copy_(b, non_blocking=True)


def _device(tree) -> torch.device:
    devs = {t.device for t in leaves(tree)}
    if len(devs) != 1:
        raise ValueError(f"the step's tensors lie on {sorted(map(str, devs))}: need one device")
    return devs.pop()


class CapturedStep:
    """``fn(state, inputs) -> (state, outputs)`` captured once and replayed
    per step; see the module docstring. ``replays`` counts the replays."""

    def __init__(self, fn, state, inputs, warmup: int = WARMUP_STEPS):
        dev = _device((state, inputs))
        if dev.type != "cuda":
            raise ValueError(f"CapturedStep captures CUDA graphs; the step's tensors lie on {dev} "
                             "(run the step eagerly there)")
        if torch.backends.cuda.preferred_linalg_library() != torch._C._LinalgBackend.Cusolver:
            raise RuntimeError("CapturedStep needs every factorization in cuSOLVER (MAGMA's batched "
                               "paths synchronize the host): call core.device.card_numerics() first")
        from larvio_tpu_torch.ops.cuda_lib import kernel_launches

        self.device = dev
        self._state = tree_map(torch.clone, state)
        self._inputs = tree_map(torch.clone, inputs)
        self._in_leaves = list(leaves(self._inputs))
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            scratch = tree_map(torch.clone, self._state)
            for _ in range(warmup):
                scratch, _ = fn(scratch, self._inputs)
        main.wait_stream(side)
        del scratch
        before = kernel_launches()
        self._graph = torch.cuda.CUDAGraph()
        # thread_local: a decode or render thread may use the card meanwhile
        with torch.cuda.graph(self._graph, stream=side, capture_error_mode="thread_local"):
            new_state, out = fn(self._state, self._inputs)
            self._out = tree_map(torch.clone, out)
            copy_into(self._state, new_state)
        after = kernel_launches()
        self.launches_per_replay = {k: after[k] - before[k] for k in after}
        self.replays = 0

    def load(self, state) -> None:
        """Copy ``state`` into the static state (a new sequence, an
        injection, a resume)."""
        copy_into(self._state, state)

    def state(self):
        """A clone of the static state (the state after the last replay)."""
        return tree_map(torch.clone, self._state)

    def replay(self, inputs):
        """Copy ``inputs`` into the static input buffers and run one step.
        Returns the output slot (overwritten by the next replay)."""
        ins = list(leaves(inputs))
        if len(ins) != len(self._in_leaves):
            raise ValueError(f"replay: {len(ins)} input leaves, the captured step has "
                             f"{len(self._in_leaves)}")
        for d, s in zip(self._in_leaves, ins):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"replay: input {s.dtype} {tuple(s.shape)}, the captured step "
                                 f"holds {d.dtype} {tuple(d.shape)}")
            if s is not d:
                d.copy_(s, non_blocking=True)
        self._graph.replay()
        self.replays += 1
        return self._out


def scan(step, carry, xs, graph=None):
    """``core.tree.scan(step, carry, xs)``, one replay of a captured ``step``
    per element of the leading (time) axis of ``xs``.

    ``graph``: None captures when the tensors lie on the card and runs the
    eager loop (``core.tree.scan``) on the CPU; False always runs the eager
    loop; True always captures, and raises on the CPU; a ``CapturedStep``
    of ``step`` is loaded with ``carry`` and replayed as it is.

    Each replay's outputs are copied into a preallocated (T, ...) buffer on
    the device (``buf[k]`` is a view made on the host: the loop reads
    nothing back). Returns (final carry, outputs with a leading time axis),
    equal bit for bit to the eager loop's on the same device."""
    if graph is False or (graph is None and _device((carry, xs)).type != "cuda"):
        return tree_scan(step, carry, xs)
    n = next(iter(leaves(xs))).shape[0]
    if isinstance(graph, CapturedStep):
        graph.load(carry)
    else:
        graph = CapturedStep(step, carry, tree_map(lambda a: a[0], xs))
    bufs = None
    for k in range(n):
        out = graph.replay(tree_map(lambda a: a[k], xs))
        if bufs is None:
            outs = tree_map(lambda a: a.new_empty((n, *a.shape)), out)
            bufs = list(leaves(outs))
        for buf, o in zip(bufs, leaves(out)):
            buf[k].copy_(o)
    return graph.state(), outs

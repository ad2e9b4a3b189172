"""One frame step captured as a CUDA graph and replayed in place, and the
cache of such steps: the port's counterpart of ``jax.jit`` on a step
function (its capture is jit's compile, ``CACHE`` its compile-once cache).
``select`` is the one place that decides how a step runs: every runner of
the port drives the step it returns.

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

``EagerStep(fn)`` has the same interface (``load``, ``replay``, ``state``
and ``scan``, a sequence of replays) and runs ``fn`` eagerly: it opens no
spans and records no card events.

``CACHE`` holds one ``CapturedStep`` per signature, the key ``jax.jit``
keeps: the entry (the step's name and its static arguments, e.g.
``("pipeline_step", cfg)``; step functions are made per call, so their
identity cannot serve), the device, the tree structure of (state, inputs)
and every leaf's shape and dtype. The first call of a signature captures;
every later one replays that graph. ``CACHE.captures`` counts the captures,
``CACHE.clear()`` drops every step and frees the graphs' memory pools. On
the CPU nothing is cached: the eager step runs.

The entry layer's spans (``core/stages.py``'s tracer, ``CACHE.tracer``):
``entry.call`` around ``call`` with its children ``entry.signature`` (the
cache's key and lookup), ``entry.load``, ``entry.replay`` and
``entry.clone`` (the new state's and the outputs' clones); ``entry.scan``
around ``scan`` with ``entry.signature``, ``entry.load``, an
``entry.replay`` per frame and ``entry.clone`` for the state;
``entry.capture`` around a capture (the eager warm-up steps and the graph's
capture). ``entry.replay`` (the input copies and ``CUDAGraph.replay()``)
carries card events, recorded outside the graph. On the card ``entry.call``
and ``entry.scan`` carry ``copies``, the leaf copies and clones the call
launches (``CapturedStep.copies``), and ``entry.scan`` its ``replays``.

Nothing falls back to eager execution on the card: a CPU device raises, and
a failed capture or replay raises to the caller. Every factorization must
run in cuSOLVER (``core/device.py::card_numerics``): PyTorch's MAGMA paths
for batched factorizations synchronize the host and cannot be captured.
"""

from __future__ import annotations

import dataclasses

import torch

from larvio_tpu_torch.core.stages import TRACER
from larvio_tpu_torch.core.tree import leaves, tree_map

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


class _Step:
    """What both kinds of step share: a sequence of replays."""

    def scan(self, carry, xs):
        """Load ``carry``, replay once per element of the leading (time)
        axis of ``xs``, each replay's outputs copied into a preallocated
        (T, ...) buffer on the device (``buf[k]`` is a view made on the
        host: the loop reads nothing back). Returns (final state, outputs
        with a leading time axis)."""
        n = next(iter(leaves(xs))).shape[0]
        self.load(carry)
        bufs = None
        for k in range(n):
            out = self.replay(tree_map(lambda a: a[k], xs))
            if bufs is None:
                outs = tree_map(lambda a: a.new_empty((n, *a.shape)), out)
                bufs = list(leaves(outs))
            for buf, o in zip(bufs, leaves(out)):
                buf[k].copy_(o)
        return self.state(), outs


class EagerStep(_Step):
    """``fn(state, inputs) -> (state, outputs)`` run eagerly; see the
    module docstring."""

    def __init__(self, fn):
        self._fn, self._state = fn, None

    def load(self, state) -> None:
        self._state = state

    def state(self):
        return self._state

    def replay(self, inputs):
        self._state, out = self._fn(self._state, inputs)
        return out


class CapturedStep(_Step):
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
        self.device = dev
        with TRACER.span("entry.capture"):
            self._capture(fn, state, inputs, warmup)

    def _capture(self, fn, state, inputs, warmup: int) -> None:
        from larvio_tpu_torch.ops.cuda_lib import kernel_launches

        dev = self.device
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
        self._n_state = len(list(leaves(self._state)))
        self._n_io = len(self._in_leaves) + len(list(leaves(self._out)))

    def copies(self, n: int = 1) -> int:
        """The leaf copies and clones that a call of ``n`` replays launches
        (1: ``call``; n: ``scan``), every leaf copied: the load and the
        state's clones, and per replay the input copies and the outputs'
        clones or copies."""
        return 2 * self._n_state + n * self._n_io

    def load(self, state) -> None:
        """Copy ``state`` into the static state (a new sequence, an
        injection, a resume)."""
        with TRACER.span("entry.load"):
            copy_into(self._state, state)

    def state(self):
        """A clone of the static state (the state after the last replay)."""
        with TRACER.span("entry.clone"):
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
        with TRACER.span("entry.replay", card=True):
            for d, s in zip(self._in_leaves, ins):
                if s is not d:
                    d.copy_(s, non_blocking=True)
            self._graph.replay()
        self.replays += 1
        return self._out


def _structure(tree):
    """A hashable description of a tree's containers (its treedef)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree), tuple((f.name, _structure(getattr(tree, f.name))) for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return dict, tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_structure(x) for x in tree)
    return None


def signature(entry, tree) -> tuple:
    """The cache key of a call with arguments ``tree`` (see the module
    docstring): ``entry``, the device, the tree structure, and each leaf's
    shape and dtype."""
    return (entry, _device(tree), _structure(tree), tuple((tuple(t.shape), t.dtype) for t in leaves(tree)))


class StepCache:
    """One ``CapturedStep`` per signature (see the module docstring)."""

    def __init__(self):
        self._steps = {}
        self.captures = 0
        self.tracer = TRACER

    def step(self, entry, fn, state, inputs) -> CapturedStep:
        """The captured step of ``fn`` for this signature: captured now if
        the cache has none (raises for CPU tensors), else the cached one,
        whatever state it holds (load one before replaying it)."""
        key = signature(entry, (state, inputs))
        if key not in self._steps:
            self._steps[key] = CapturedStep(fn, state, inputs)
            self.captures += 1
        return self._steps[key]

    def graphs(self) -> list:
        return list(self._steps.values())

    def __len__(self) -> int:
        return len(self._steps)

    def clear(self) -> None:
        """Drop every captured step; their graphs' memory pools go back to
        the card."""
        self._steps.clear()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


CACHE = StepCache()


def select(graph, entry, fn, state, inputs):
    """The step that runs ``fn`` on arguments like (``state``, ``inputs``):
    for ``graph=None``, ``CACHE``'s ``CapturedStep`` for ``entry`` and this
    signature on the card (captured at its first call) and an
    ``EagerStep`` on the CPU; for ``graph=False``, an ``EagerStep``. Any
    other ``graph`` raises. The only code that picks eager or captured."""
    if graph is not None and graph is not False:
        raise ValueError(f"graph={graph!r}: None (the cached captured step on the card, the eager "
                         "step on the CPU) or False (the eager step)")
    if graph is False or _device((state, inputs)).type != "cuda":
        return EagerStep(fn)
    return CACHE.step(entry, fn, state, inputs)


def call(entry, fn, state, inputs, graph=None):
    """``fn(state, inputs)`` through the step ``graph`` selects (``select``):
    the jitted entry points' call. Returns (state, outputs), new tensors."""
    with TRACER.span("entry.call") as sp:
        with TRACER.span("entry.signature"):
            step = select(graph, entry, fn, state, inputs)
        if isinstance(step, EagerStep):
            return fn(state, inputs)
        sp.set(copies=step.copies())
        step.load(state)
        out = step.replay(inputs)
        with TRACER.span("entry.clone"):
            return tree_map(torch.clone, step._state), tree_map(torch.clone, out)


def scan(entry, fn, carry, xs, graph=None):
    """``fn`` over the leading (time) axis of ``xs`` from ``carry`` (the
    JAX package's ``lax.scan``): the step ``graph`` selects (``select``)
    runs its ``scan``, on the card one replay of ``CACHE``'s step per
    element. Returns (final carry, outputs with a leading time axis), equal
    bit for bit on the card and off it to the plain per-frame loop on the
    same device."""
    with TRACER.span("entry.scan") as sp:
        with TRACER.span("entry.signature"):
            step = select(graph, entry, fn, carry, tree_map(lambda a: a[0], xs))
        if isinstance(step, CapturedStep):
            n = next(iter(leaves(xs))).shape[0]
            sp.set(replays=n, copies=step.copies(n))
        return step.scan(carry, xs)

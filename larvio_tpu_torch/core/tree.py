"""State containers as plain dataclasses of tensors, the tree helpers the
filter needs (``tree_map``, ``tree_where``), and the batch-axis helpers that
let one implementation serve one instance and a fleet.

``tree_where`` is the port of the JAX package's whole-state
``jax.tree.map(lambda a, b: jnp.where(c, a, b), ...)`` selects: it computes
both branches and selects on the device, so the frame step never reads a
tensor back to the host to branch on it.

Batch convention: a fleet state has the same leaves as one instance with a
leading instance axis B. A per-instance condition then has shape (B,) where
a single instance's has shape (). ``where`` broadcasts such a condition over
the TRAILING axes of its operands (numpy would align it with the last axis),
so a select stays per lane and never mixes lanes. ``take`` gathers along one
axis with per-lane indices, where the single-instance code indexed with
``x[idx]``.
"""

from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin for state dataclasses: ``replace`` like flax's struct.dataclass."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_map(fn, *trees):
    """Map ``fn`` over matching leaves of dataclasses / tuples / lists / dicts."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return fn(*trees)


def scan(step, carry, xs):
    """``jax.lax.scan`` as a Python loop: ``step(carry, x) -> (carry, out)``
    over the leading (time) axis of every leaf of ``xs``; the outputs are
    stacked on a new leading axis."""
    n = next(iter(leaves(xs))).shape[0]
    outs = []
    for k in range(n):
        carry, out = step(carry, tree_map(lambda a: a[k], xs))
        outs.append(out)
    return carry, tree_map(lambda *o: torch.stack(o), *outs)


def leaves(tree):
    """The leaves of a tree of dataclasses / tuples / lists, in field order
    (the JAX package's flatten order for the same structure)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from leaves(x)
    else:
        yield tree


def where(cond: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` with ``cond`` aligned to the LEADING axes of a and b:
    cond (*lead,) selects whole trailing blocks of a, b (*lead, ...)."""
    nd = max(x.dim() if isinstance(x, torch.Tensor) else 0 for x in (a, b))
    return torch.where(cond.reshape(cond.shape + (1,) * (nd - cond.dim())), a, b)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``where(cond, a, b)`` over two trees of equal structure; cond
    is per instance ((), or (B,) for a fleet)."""
    return tree_map(lambda x, y: where(cond, x, y), a, b)


def take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x[..., idx, ...]`` along axis ``dim`` with per-lane indices.

    x (*lead, N, *tail), idx (*lead, K) or (K,) -> (*lead, K, *tail); the
    single-instance case (lead = ()) is ``x[idx]`` along that axis.
    """
    d = dim % x.dim()
    tail = x.shape[d + 1:]
    # int64: gather misreads an expanded (stride-0) int32 index (the slots
    # of the state are int32)
    idx = idx.to(torch.int64).expand(*x.shape[:d], idx.shape[-1])
    return torch.gather(x, d, idx.reshape(idx.shape + (1,) * len(tail)).expand(*idx.shape, *tail))


def take1(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``take`` of one index per row: x (*lead, N, *tail), idx (*lead,) ->
    (*lead, *tail)."""
    return take(x, idx[..., None], dim).squeeze(dim % x.dim())


def all_finite(x: torch.Tensor, n_batch: int) -> torch.Tensor:
    """Per-lane ``isfinite(x).all()`` over every axis after the first ``n_batch``."""
    return torch.isfinite(x).reshape(*x.shape[:n_batch], -1).all(dim=-1)

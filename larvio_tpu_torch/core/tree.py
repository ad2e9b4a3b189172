"""State containers as plain dataclasses of tensors, and the two tree helpers
the filter needs: ``tree_map`` and ``tree_where``.

``tree_where`` is the port of the JAX package's whole-state
``jax.tree.map(lambda a, b: jnp.where(c, a, b), ...)`` selects: it computes
both branches and selects on the device, so the frame step never reads a
tensor back to the host to branch on it.
"""

from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin for state dataclasses: ``replace`` like flax's struct.dataclass."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_map(fn, *trees):
    """Map ``fn`` over matching leaves of dataclasses / tuples / lists."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return fn(*trees)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` over two trees of equal structure."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)

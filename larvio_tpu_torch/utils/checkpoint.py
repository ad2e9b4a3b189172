"""Filter-state checkpoint / resume (port of ``larvio_tpu/utils/checkpoint.py``).

The whole estimator is one tree of tensors (a ``PipelineState``,
``VioState``, ``FilterState``, a fleet's batched state), so saving it and
restoring it into a fresh template continues a run as if uninterrupted.

The file is always the ``.npz`` form that the JAX package falls back to
without Orbax: leaf ``i`` of the tree, in the JAX package's flatten order
(dataclass field order, which the port's dataclasses mirror, tuples in
order), is stored as ``leaf_{i}``, and the descriptor words as uint32. A
checkpoint written by either package therefore restores in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from larvio_tpu_torch.convert import to_reference_numpy
from larvio_tpu_torch.core.tree import leaves, tree_map


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def save_state(path: str, state) -> str:
    """Save a state tree as ``.npz`` (appended to ``path`` when it lacks it);
    returns the file's path."""
    npz = _npz_path(path)
    leaves = _flatten(to_reference_numpy(state))
    np.savez_compressed(npz, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    return npz


def restore_state(path: str, template):
    """Restore a checkpoint into the structure of ``template`` (same config
    and shapes), on the template's device."""
    with np.load(_npz_path(path)) as data:
        saved = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n = sum(1 for _ in leaves(template))
    if len(saved) != n:
        raise ValueError(f"checkpoint holds {len(saved)} leaves, the template {n}")
    it = iter(saved)

    def restore(t: torch.Tensor) -> torch.Tensor:
        a = next(it)
        if a.dtype == np.uint32:
            a = a.view(np.int32)  # descriptor words: the port keeps int32 bit patterns
        if a.shape != tuple(t.shape) or torch.from_numpy(np.empty(0, a.dtype)).dtype != t.dtype:
            raise ValueError(f"checkpoint leaf {a.dtype} {a.shape} does not fit {t.dtype} {tuple(t.shape)}")
        return torch.from_numpy(a.copy()).to(t.device)

    return tree_map(restore, template)

"""Prefix scans in the JAX package's combination order.

``associative_scan`` reproduces ``jax.lax.associative_scan``'s recursion
(pairwise reduce, recurse on the odd half, fill the even half): the JAX
propagation builds its ordered transition products with it.

``cumsum`` reproduces ``jnp.cumsum`` as XLA runs it on the CPU: the
cumulative reduce-window is rewritten into blocks of 16, summed sequentially
inside each block, with the block totals scanned the same way recursively
and added as a carry. Matching that order keeps float prefix sums (RANSAC's
cumulative sampling probabilities, the velocity/position chains)
bit-identical to the JAX package on the CPU. Both take few dependent steps
on the card, and both scan along any axis (``dim``): the other axes, a
fleet's instance axis among them, ride along.
"""

from __future__ import annotations

import torch


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along axis 0 (len(a) == len(b) or len(b) + 1)."""
    n = a.shape[0] + b.shape[0]
    out = torch.empty((n, *a.shape[1:]), dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive scan of ``fn`` over axis ``dim``; ``fn(a, b)`` combines an
    earlier prefix ``a`` with a later element ``b`` (both with the scanned
    axis moved to the front)."""
    if dim != 0:
        return associative_scan(fn, elems.movedim(dim, 0)).movedim(0, dim)
    n = elems.shape[0]
    if n < 2:
        return elems
    reduced = fn(elems[0:-1:2], elems[1::2])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(odd[:-1], elems[2::2])
    else:
        even = fn(odd, elems[2::2])
    even = torch.cat([elems[:1], even], dim=0)
    return _interleave(even, odd)


_BLOCK = 16


def _sequential(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 1, strictly left to right in x's dtype."""
    cols = [x[:, 0]]
    for i in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, i])
    return torch.stack(cols, dim=1)


def cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum over axis ``dim`` in ``jnp.cumsum``'s CPU order."""
    if dim != 0:
        return cumsum(x.movedim(dim, 0)).movedim(0, dim)
    n = x.shape[0]
    if n <= _BLOCK:
        return _sequential(x[None])[0]
    m = -(-n // _BLOCK) * _BLOCK
    xp = torch.cat([x, torch.zeros((m - n, *x.shape[1:]), dtype=x.dtype, device=x.device)])
    within = _sequential(xp.reshape(m // _BLOCK, _BLOCK, *x.shape[1:]))
    totals = cumsum(within[:, -1])
    carry = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (carry[:, None] + within).reshape(m, *x.shape[1:])[:n]

"""What the oracle's intersections share: the blocked closest-hit scan and
the differentiable row lookup."""

from __future__ import annotations

import torch
from torch.nn.functional import embedding

from rt_torch.config import FLT_MAX


def gather_rows(tab, idx):
    """``tab[idx]`` for a (K, C) table and an integer tensor of row ids, as
    an embedding lookup.  The forward pass is the same index gather; the
    backward pass must add millions of pixels' cotangents into a handful of
    rows, and the indexing operator's own backward (``index_put_`` with
    accumulate) walks the duplicates of a row one by one, while the
    embedding's sorts the ids and sums them by segments."""
    return embedding(idx.long(), tab)


def _first_min(t, valid):
    """(least t over the last axis where valid, its FIRST index), inf and
    the axis length where nothing is valid."""
    tt = torch.where(valid, t, torch.inf)
    low = tt.amin(dim=-1)
    pos = torch.arange(t.shape[-1], device=t.device)
    first = torch.where(tt == low[..., None], pos, t.shape[-1]).amin(dim=-1)
    return low, first


def closest_hit(t_of, count: int, shape, device, block: int):
    """The closest-hit scan over ``count`` primitives in blocks: t_of(lo,
    hi) gives (valid, t) of every lane against primitives lo..hi-1, shape
    (..., hi - lo).  Within a block the least valid t and its first index,
    across blocks a strict ``t < best``: the winner of the sequential scan
    in ascending order with a strict ``t < best`` (the earliest index wins
    an exact tie).  Returns (t f32 with FLT_MAX on a miss, index int64, -1
    on a miss), without a graph."""
    best_t = torch.full(shape, FLT_MAX, dtype=torch.float32, device=device)
    best_i = torch.full(shape, -1, dtype=torch.int64, device=device)
    with torch.no_grad():
        for lo in range(0, count, block):
            valid, t = t_of(lo, min(lo + block, count))
            low, first = _first_min(t, valid)
            better = low < best_t
            best_t = torch.where(better, low, best_t)
            best_i = torch.where(better, first + lo, best_i)
    return best_t, best_i

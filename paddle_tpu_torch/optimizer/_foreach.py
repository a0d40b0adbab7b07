"""Helpers of the eager optimizers' and clips' ``torch._foreach_*`` passes."""
from __future__ import annotations

from typing import List

import torch

CHUNK = 1 << 26            # elements a foreach pass holds at most


def chunks(items, numel):
    """Split ``items`` into runs of at most CHUNK elements (by
    ``numel(item)``; an item larger than that is a run of its own), so a
    pass's temporaries stay bounded."""
    run, n = [], 0
    for it in items:
        k = numel(it)
        if run and n + k > CHUNK:
            yield run
            run, n = [], 0
        run.append(it)
        n += k
    if run:
        yield run


def f32_copies(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``ts`` with every non-fp32 tensor replaced by an exact fp32 copy,
    made by one foreach copy; fp32 tensors are returned as they are, not
    copied."""
    out = list(ts)
    low = [i for i, t in enumerate(ts) if t.dtype != torch.float32]
    if low:
        bufs = [torch.empty_like(ts[i], dtype=torch.float32) for i in low]
        torch._foreach_copy_(bufs, [ts[i] for i in low])
        for i, b in zip(low, bufs):
            out[i] = b
    return out

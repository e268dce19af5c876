"""O(1) range-maximum queries over per-segment version arrays (plain torch).

The plain versions of ``foundationdb_tpu/ops/rmq.py``'s ``sparse_table``
and ``range_max``. On the card the table is built and queried by
kernels/csrc/history_probe.cu.
"""

from __future__ import annotations

import math

import torch


def sparse_table(values: torch.Tensor) -> torch.Tensor:
    """ST[l, i] = max(values[i : i + 2**l]) for l in [0, ceil_log2(N)].

    values: [N] int32. Returns [L, N]; out-of-range tails are clamped to the
    last valid window, exactly as the JAX table (row l reads row l-1 at
    ``min(i + 2**(l-1), N-1)``)."""
    n = values.shape[0]
    if n == 0:
        return values.new_zeros((1, 0))
    levels = max(1, math.ceil(math.log2(n))) + 1
    idx = torch.arange(n, device=values.device)
    rows = [values]
    for l in range(1, levels):
        prev = rows[-1]
        shifted = prev[(idx + (1 << (l - 1))).clamp(max=n - 1)]
        rows.append(torch.maximum(prev, shifted))
    return torch.stack(rows)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive int32 x (the JAX ``31 - _clz32(x)``),
    by bit smearing and popcount in int64 so no sign bit intervenes."""
    x = x.long()
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    pop = torch.zeros_like(x)
    for b in range(32):
        pop += (x >> b) & 1
    return (pop - 1).to(torch.int32)


def range_max(st: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              neg_inf: int) -> torch.Tensor:
    """max(values[lo:hi]) for int32 index arrays; empty ranges (hi <= lo)
    return neg_inf. Two overlapping windows of the level floor(log2 len).
    Gather indices are clamped into range, as JAX clamps them."""
    n = st.shape[1]
    length = hi - lo
    valid = length > 0
    lvl = floor_log2(length.clamp(min=1)).long()
    w = (1 << lvl).to(torch.int32)
    a = st[lvl, lo.clamp(0, n - 1).long()]
    b = st[lvl, (hi - w).clamp(0, n - 1).long()]
    out = torch.maximum(a, b)
    return torch.where(valid, out, torch.full_like(out, neg_inf))

"""O(1) range-maximum queries over per-segment version arrays (plain torch).

The plain versions of ``foundationdb_tpu/ops/rmq.py``'s ``sparse_table``
and ``range_max`` (on the card built and queried by
kernels/csrc/history_probe.cu) and of its two-level blocked structure,
``block_table`` and ``range_max_blocked`` (on the card
kernels/csrc/rmq_blocked.cu, K17, which builds the top table in the same
launch), and the plain twins of K17's live build and query,
``block_table_live`` and ``range_max_blocked_live``: the structure over a
history's live rows [0, n_used) only, each range's end clamped to them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

RMQ_BLOCK = 256


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


def windowed_table(values: torch.Tensor) -> torch.Tensor:
    """``sparse_table`` by its closed form, as K2's table kernel computes
    it: ST[l, i] = max(values[i : min(i + 2**l, N)]), each level from the
    one below with the positions past the end read as INT32_MIN (a tile
    padded at the array's end) in place of the JAX clamp to N - 1. The two
    agree: a window that reaches the end already holds values[N - 1]."""
    n = values.shape[0]
    if n == 0:
        return values.new_zeros((1, 0))
    levels = max(1, math.ceil(math.log2(n))) + 1
    rows = [values]
    for l in range(1, levels):
        d = min(1 << (l - 1), n)
        prev = rows[-1]
        shifted = torch.cat([prev[d:], prev.new_full((d,), -(2**31))])
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
    Gather indices are clamped into range, as JAX clamps them (the level
    too, for a range longer than the table: only an out-of-range query of
    the blocked structure's top table makes one)."""
    n = st.shape[1]
    length = hi - lo
    valid = length > 0
    lvl = floor_log2(length.clamp(min=1)).long()
    w = (1 << lvl).to(torch.int32)
    row = lvl.clamp(max=st.shape[0] - 1)
    a = st[row, lo.clamp(0, n - 1).long()]
    b = st[row, (hi - w).clamp(0, n - 1).long()]
    out = torch.maximum(a, b)
    return torch.where(valid, out, torch.full_like(out, neg_inf))


class BlockTable(NamedTuple):
    """The two-level blocked structure over ``values`` [N] (the JAX
    ``BlockTable``): blocks of RMQ_BLOCK rows, padded with neg_inf."""

    rows: torch.Tensor  # [NB, G] the values, padded
    prefix: torch.Tensor  # [NB, G] cummax from the block start
    suffix: torch.Tensor  # [NB, G] cummax toward the block start
    top: torch.Tensor  # sparse table over the block maxima [L, NB]


def block_table(values: torch.Tensor, neg_inf: int,
                block: int = RMQ_BLOCK) -> BlockTable:
    """The JAX ``block_table``: in-block prefix and suffix cummax and a
    sparse table over the block maxima."""
    n = values.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    v = torch.cat([values, values.new_full((pad,), neg_inf)]) if pad \
        else values
    rows = v.reshape(nb, block)
    prefix = torch.cummax(rows, 1).values
    suffix = torch.cummax(rows.flip(1), 1).values.flip(1)
    return BlockTable(rows, prefix, suffix,
                      sparse_table(rows.max(1).values))


def range_max_blocked(bt: BlockTable, lo: torch.Tensor, hi: torch.Tensor,
                      neg_inf: int, block: int = RMQ_BLOCK) -> torch.Tensor:
    """max(values[lo:hi]) with numpy-slice semantics, empty -> neg_inf (the
    JAX ``range_max_blocked``): a query inside one block takes the masked
    max of its row, any other the suffix of its first block, the prefix of
    its last and the top table over the blocks between. Gather indices are
    clamped into range, as JAX clamps them."""
    nb = bt.rows.shape[0]
    valid = hi > lo
    last = (hi - 1).clamp(min=0)
    safe_lo = lo.clamp(min=0).clamp(max=nb * block - 1)
    bl, il = safe_lo // block, safe_lo % block
    bh, ih = last // block, last % block
    blc, bhc = bl.clamp(max=nb - 1).long(), bh.clamp(max=nb - 1).long()
    cross = torch.maximum(bt.suffix[blc, il.long()], bt.prefix[bhc, ih.long()])
    cross = torch.maximum(cross, range_max(bt.top, bl + 1, bh, neg_inf))
    j = torch.arange(block, dtype=torch.int32, device=lo.device)
    mask = (j >= il[..., None]) & (j <= ih[..., None])
    same = torch.where(mask, bt.rows[blc], neg_inf).max(-1).values
    out = torch.where(bl == bh, same, cross)
    return torch.where(valid, out, torch.full_like(out, neg_inf))


def block_table_live(values: torch.Tensor, n_used: int, neg_inf: int,
                     block: int = RMQ_BLOCK) -> BlockTable | None:
    """K17's live build, plain: ``block_table`` over the live rows
    ``values[:n_used]`` only (None when there are none)."""
    n = min(max(int(n_used), 0), values.shape[0])
    return block_table(values[:n], neg_inf, block) if n else None


def range_max_blocked_live(bt: BlockTable | None, lo: torch.Tensor,
                           hi: torch.Tensor, n_used: int, neg_inf: int,
                           block: int = RMQ_BLOCK) -> torch.Tensor:
    """K17's live query, plain: max(values[max(lo, 0):min(hi, n_used)])
    over ``block_table_live``'s structure, empty -> neg_inf. Every row of
    the history at or past n_used being neg_inf, this is the range max
    over all its rows for any 0 <= hi <= C."""
    if bt is None:
        return torch.full_like(lo, neg_inf)
    n = min(int(n_used), bt.rows.numel())
    return range_max_blocked(bt, lo.clamp(min=0), hi.clamp(max=n), neg_inf,
                             block)

"""Binary search, clamps and sorts over packed multi-word keys, in plain
torch.

Keys are ``[..., W]`` int32 word vectors (see core/keypack.py) in
column-lexicographic order. These are the plain versions of
``foundationdb_tpu/ops/lex.py``'s ``searchsorted_words``,
``searchsorted_words_fp``, ``searchsorted_words_2sided_fp``, ``lex_max``,
``lex_min`` and ``sort_keys_with_payload``; on the card the same searches,
clamps and sorts run inside the hand-written kernels
(kernels/csrc/dict_insert.cu, history_probe.cu, step_compact.cu,
word_probe.cu, word_compact.cu, word_sort.cu, word_shard.cu), never
through these functions.
"""

from __future__ import annotations

import math

import torch


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically on the trailing word axis (broadcasting)."""
    w = a.shape[-1]
    lt = a[..., w - 1] < b[..., w - 1]
    for j in range(w - 2, -1, -1):
        lt = (a[..., j] < b[..., j]) | ((a[..., j] == b[..., j]) & lt)
    return lt


def lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~lex_lt(b, a)


def searchsorted_words(
    sorted_keys: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """int32 insertion indices of ``[..., W]`` queries into a sorted
    ``[N, W]`` array, with numpy.searchsorted semantics (``side`` left or
    right). Same static trip count, ceil(log2(N+1)), as the JAX version."""
    n = sorted_keys.shape[0]
    shape = queries.shape[:-1]
    dev = queries.device
    if n == 0:
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    steps = max(1, math.ceil(math.log2(n + 1)))
    lo = torch.zeros(shape, dtype=torch.int32, device=dev)
    hi = torch.full(shape, n, dtype=torch.int32, device=dev)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        a = sorted_keys[mid.clamp(max=n - 1).long()]
        go_right = lex_lt(a, queries) if side == "left" else lex_le(a, queries)
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def searchsorted_words_fp(
    sorted_keys: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """The JAX package's column-cascade ("fingerprint") search returns the
    same indices as :func:`searchsorted_words`; only its memory access
    pattern differs, which a plain version has no reason to copy."""
    return searchsorted_words(sorted_keys, queries, side)


def searchsorted_words_2sided_fp(
    sorted_keys: torch.Tensor, queries: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(left, right) insertion indices of ``[..., W]`` queries into a sorted
    ``[N, W]`` array, as the JAX column-cascade search returns them (its
    run of equal keys is exactly [left, right))."""
    return (searchsorted_words(sorted_keys, queries, "left"),
            searchsorted_words(sorted_keys, queries, "right"))


def lex_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise lexicographic max of ``[..., W]`` key vectors
    (broadcasting), the JAX ``lex_max``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.where(lex_lt(a, b)[..., None], b, a)


def lex_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise lexicographic min (the JAX ``lex_min``)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.where(lex_lt(a, b)[..., None], a, b)


def sort_keys_with_payload(
    keys: torch.Tensor, *payloads: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Stable lexicographic sort of ``[N, W]`` keys carrying payload
    columns: (sorted_keys, *sorted_payloads), the permutation of the JAX
    ``lax.sort(..., num_keys=W, is_stable=True)``. W stable passes of
    ``torch.sort``, least significant word first; on the card the sort is
    K14 (kernels/csrc/word_sort.cu), never this function."""
    n, w = keys.shape
    perm = torch.arange(n, device=keys.device)
    for j in range(w - 1, -1, -1):
        order = torch.sort(keys[perm, j], stable=True).indices
        perm = perm[order]
    return (keys[perm], *(p[perm] for p in payloads))

"""uint32 bitsets kept as int32 bit patterns (plain torch).

Torch has few uint32 operations, so a packed word is an int32 holding the
same 32 bits as the JAX package's uint32 (compare through numpy
``.view(np.uint32)``). Bit 0 of word 0 is element 0; lengths are multiples
of 32. Plain versions of ``foundationdb_tpu/ops/bitset.py``; on the card
the packed rows are built and consumed inside kernels/csrc/accept.cu.
"""

from __future__ import annotations

import torch

WORD = 32


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_bits_u32(m: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 bit patterns [..., n // 32]."""
    *lead, n = m.shape
    if n % WORD:
        raise ValueError(f"bitset length {n} not a multiple of {WORD}")
    lanes = torch.arange(WORD, device=m.device, dtype=torch.int64)
    words = (m.reshape(*lead, n // WORD, WORD).long() << lanes).sum(-1)
    return to_int32_bits(words)


def unpack_bits_u32(p: torch.Tensor, n: int) -> torch.Tensor:
    """int32 bit patterns [..., n // 32] -> bool [..., n]."""
    lanes = torch.arange(WORD, device=p.device, dtype=torch.int64)
    bits = ((p.long() & 0xFFFFFFFF)[..., None] >> lanes) & 1
    return (bits != 0).reshape(*p.shape[:-1], n)


def or_matvec_u32(rows: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """bool [M]: does packed row i intersect the packed vector — the
    bitwise form of ``(M_bool @ v_bool) > 0``."""
    return ((rows & vec[None, :]) != 0).any(-1)

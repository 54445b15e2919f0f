"""Packed presence bits for the queue checkers' per-value verdict masks.

A boolean vector of length ``n`` becomes ``ceil(n/32)`` 32-bit words,
bit ``j`` of word ``w`` holding element ``w*32 + j`` (little-endian bit
order, ``np.packbits(..., bitorder="little")`` compatible) — the layout
of the JAX package's ``checkers/bitset.py``.

PyTorch has no shifts on uint32 on every device, so the words are held
as int32 with the same bits; the numpy side reads them as
``.view(np.uint32)``.
"""

from __future__ import annotations

import numpy as np
import torch

#: bits per word — the packing granule
LANE_BITS = 32


def n_words(n_bits: int) -> int:
    """Words needed for ``n_bits`` packed bits."""
    return (max(int(n_bits), 1) + LANE_BITS - 1) // LANE_BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``bool [..., n]`` → ``int32 [..., ceil(n/32)]`` words with the bits
    of the uint32 layout.  The trailing axis is padded with zeros to the
    word boundary."""
    n = bits.shape[-1]
    W = n_words(n)
    pad = W * LANE_BITS - n
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (W, LANE_BITS))
    sh = torch.arange(LANE_BITS, dtype=torch.int64, device=bits.device)
    # bits are 0/1 and shifts distinct, so the sum IS the word-OR
    words = (b << sh).sum(-1)
    # reinterpret the unsigned 32-bit word as int32 (two's complement)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``int32 [..., W]`` → ``bool [..., n]`` (inverse of
    :func:`pack_bits`; ``n ≤ W*32``)."""
    sh = torch.arange(LANE_BITS, dtype=torch.int32, device=packed.device)
    # int32 >> is arithmetic: mask to the one bit after every shift
    b = (packed.to(torch.int32)[..., :, None] >> sh) & 1
    return b.reshape(packed.shape[:-1] + (-1,))[..., :n] != 0


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_bits`, as uint32 words."""
    bits = np.asarray(bits, bool)
    n = bits.shape[-1]
    W = n_words(n)
    pad = W * LANE_BITS - n
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    packed = np.ascontiguousarray(
        np.packbits(bits, axis=-1, bitorder="little")
    )
    return packed.view(np.uint32).reshape(bits.shape[:-1] + (W,))


def unpack_bits_np(packed: np.ndarray, n: int) -> np.ndarray:
    """Host twin of :func:`unpack_bits`; takes uint32 or int32 words."""
    packed = np.ascontiguousarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    bits = np.unpackbits(
        packed.view(np.uint8), axis=-1, bitorder="little"
    )
    return bits[..., :n].astype(bool)

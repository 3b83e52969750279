"""Device setup primitives (counterpart of ``pyamg_tpu/engine/setup.py``).

Ported so far: :func:`_hash_weights`, the power iteration's start
vector.  The classical-setup primitives (strength mask, Luby MIS,
coloring, PMIS) are ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

import torch

__all__ = ["_hash_weights"]

_MASK32 = 0xFFFFFFFF


def _mul32(z, c):
    """(z * c) mod 2^32 for int64 tensors 0 <= z < 2^32 and a 32-bit
    constant c, with every intermediate below 2^49 (int64 never wraps)."""
    lo = (z * (c & 0xFFFF)) & _MASK32
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_weights(n_pad, seed, device=None):
    """Deterministic pseudo-random weights in [0, 1): the reference's
    uint32 avalanche hash of the index, bit for bit, computed in int64
    with the wrap-around made explicit (PyTorch's uint32 lacks the
    operators)."""
    i = torch.arange(n_pad, dtype=torch.int64, device=device)
    z = (i + (int(seed) * 0x9E3779B9 & _MASK32)) & _MASK32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z.to(torch.float32) / 2.0 ** 32

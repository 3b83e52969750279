"""Padding helpers shared by the device formats
(counterpart of ``pyamg_tpu/sparse/formats.py::pad_to``/``pad_vector``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad_to", "pad_vector", "fit"]


def pad_to(n, multiple):
    return int(-(-n // multiple) * multiple)


def pad_vector(x, n_pad, dtype=None, device=None):
    """Zero-pad a vector (or column stack) to ``n_pad`` rows.

    A numpy array (or list) becomes a tensor on ``device`` in ``dtype``;
    a tensor keeps its device unless one is given."""
    if not isinstance(x, torch.Tensor):
        if device is None:
            raise ValueError("pass device= to stage a host array")
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    elif dtype is not None or device is not None:
        x = x.to(dtype=dtype or x.dtype, device=device or x.device)
    if x.shape[0] == n_pad:
        return x
    pad = [0, 0] * (x.ndim - 1) + [0, n_pad - x.shape[0]]
    return F.pad(x, pad)


def fit(v, n):
    """Slice or zero-pad a vector, or each lane of a K-major (K, m)
    stack, to length ``n`` (operators of one level may use different row
    paddings; the tail rows are structural zeros)."""
    m = v.shape[-1]
    if m == n:
        return v
    if m > n:
        return v[..., :n].contiguous()
    return F.pad(v, (0, n - m))

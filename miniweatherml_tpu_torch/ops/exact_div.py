"""Exact division by a number, as the kernels divide.

PyTorch computes ``tensor / number`` on the GPU, and ``number / tensor``
everywhere, as a product with a rounded reciprocal.  The CUDA kernels
divide (``csrc/exact_div.cuh``), so every plain version that a kernel must
match bit for bit divides through a 0-d tensor instead.  This module
imports nothing of the package, so every layer can use it.
"""

from __future__ import annotations

import torch

__all__ = ["exact_div"]


def exact_div(a, b):
    """a / b as one IEEE division, where either side may be a number: the
    number becomes a 0-d tensor of the other side's dtype and device."""
    if not torch.is_tensor(a):
        a = b.new_full((), a)
    elif not torch.is_tensor(b):
        b = a.new_full((), b)
    return torch.div(a, b)

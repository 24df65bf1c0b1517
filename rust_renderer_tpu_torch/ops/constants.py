"""Small constant tensors made once per (value, device, dtype).

A frame body captured into a CUDA graph cannot copy a constant from the
host, and a fresh host-to-device copy per use would stall the stream. The
cache is unbounded: a captured graph holds only the raw pointers of the
tensors it reads, so a constant must live as long as the process.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def device_constant(values, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """`torch.tensor(values, dtype, device)`, made once per key (`values` is
    a hashable number or tuple)."""
    return torch.tensor(values, dtype=dtype, device=device)

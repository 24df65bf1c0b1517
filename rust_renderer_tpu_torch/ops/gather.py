"""Packed-row gathers: per-record fields packed into one table row are
fetched with one index per record (reservoirs, lights); int32 payloads ride
in float32 columns as bit patterns.
"""

from __future__ import annotations

import torch


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, W), idx (R,) -> (R, W), indices clamped into [0, N)."""
    return table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]

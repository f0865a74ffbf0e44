"""B4, the hash table's row gather (``csrc/hash_gather.cu``): a lower bound
of its time from what a launch must move whatever its indices.

The port's own bound (``hash_gather.gather_bytes``) reads each index once
(4 B), each distinct row once and writes each gathered row once. The
distinct rows need the launch's indices, which the benchmark does not see
in a timed step (they follow the fine samples of the step's weights); so
this counts the indices and the rows written and leaves the distinct rows
out. That understates the bound (by the distinct rows' bytes, about a
fifth of the rows on the corner NeRF's batches) and can only lower the
share. ``gather_bytes`` gives the full count where the indices are known.
"""
from __future__ import annotations

from typing import Iterable

import torch

from . import peaks

SECTOR = 32


def launch_bytes(n_rows: int, row_bytes: int) -> int:
    return 4 * n_rows + n_rows * row_bytes


def bound_s(calls: Iterable[int], row_bytes: int) -> float:
    return sum(launch_bytes(n, row_bytes) for n in calls) / peaks.HBM_BYTES


def gather_bytes(idx: torch.Tensor, row_bytes: int):
    """(bound bytes, sector bytes) of a gather of the rows idx [N] (a copy of
    the port's ``hash_gather.gather_bytes``): each index read once, each
    distinct row once, each output row written once; and the same at 32-byte
    grain, the table as each distinct sector a gathered row touches."""
    n = idx.shape[0]
    rows = torch.unique(idx.long())
    bound = 4 * n + rows.numel() * row_bytes + n * row_bytes
    first = rows * row_bytes // SECTOR
    last = (rows * row_bytes + row_bytes - 1) // SECTOR
    span = (row_bytes + SECTOR - 1) // SECTOR + 1
    sec = first[:, None] + torch.arange(span, device=idx.device)
    sectors = torch.unique(sec[sec <= last[:, None]]).numel()
    whole = lambda b: -(-b // SECTOR) * SECTOR  # noqa: E731
    return bound, whole(4 * n) + sectors * SECTOR + whole(n * row_bytes)

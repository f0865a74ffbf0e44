"""B4', the hash table's scatter-add (``csrc/hash_gather.cu``): a lower
bound of one launch's time from what it must move whatever its indices.

It reads each index (4 B) and each cotangent row once, and writes the
table's gradient, a dense tensor of every row of the table, once. Adding
rows that share an index touches each distinct row, which the output's
bytes already cover.
"""
from __future__ import annotations

from typing import Iterable

from . import peaks


def launch_bytes(n_rows: int, row_bytes: int, table_rows: int) -> int:
    return 4 * n_rows + n_rows * row_bytes + table_rows * row_bytes


def bound_s(calls: Iterable[int], row_bytes: int, table_rows: int) -> float:
    return sum(launch_bytes(n, row_bytes, table_rows) for n in calls) / peaks.HBM_BYTES

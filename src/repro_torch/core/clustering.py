"""Shape buckets shared by the port's batched drivers.

Only `bucket_size` so far: the query-eval driver buckets its stack depth,
clause, group and radix counts with it, and `EvalCache` pads the column
stack's partition axis to it.  KMeans and HAC join in a later slice.
"""
from __future__ import annotations

MIN_BUCKET = 8


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two ≥ max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()

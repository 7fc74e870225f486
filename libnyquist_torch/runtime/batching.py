"""Shape bucketing for the segment path.

The reference pads each (LM, shortBlocks) segment's frame count to a
bucket (next power of two above a floor) so its jitted programs compile
once per bucket. The port keeps the same buckets, so both packages run
the synthesis products over the same padded frame batches.
"""

from __future__ import annotations


def bucket_size(n: int, minimum: int) -> int:
    """Smallest power of two >= max(n, minimum)."""
    b = max(int(minimum), 1)
    n = max(int(n), 1)
    while b < n:
        b <<= 1
    return b

"""
Shapes that the per-layer metrics' work functions share: the blocked
engine's padded factor size.
"""

from __future__ import annotations


def padded_size(m):
    """The size to which the blocked engine pads an (m, m) factor input:
    the next multiple of 8 up to 128 rows, of 64 up to 256, else of
    128."""
    step = 8 if m <= 128 else 64 if m <= 256 else 128
    return -(-m // step) * step

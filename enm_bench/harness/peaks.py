"""
The card's peaks (NVIDIA H100 SXM data sheet, 700 W) and a layer's share
of its roofline: the least time its work could take, the larger of its
bytes at the memory bandwidth and its operations at the arithmetic peak,
over the device time its kernels took.  Each input byte counts once and
each output byte once, for the work the cell's shapes need.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def bound_s(nbytes, flops, f64=False):
    """The least time for `nbytes` moved and `flops` computed."""
    return max(nbytes / HBM_BYTES_PER_S,
               flops / (F64_FLOPS if f64 else F32_FLOPS))


def roofline_pct(nbytes, flops, seconds, f64=False):
    """Percent of the roofline, or ``None`` where nothing ran."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(nbytes, flops, f64) / seconds

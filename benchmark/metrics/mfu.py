"""Share of the card's f32 peak that the whole traced window reaches: the
operations the benchmark counts for the cell's kernels on the same rays,
over the window's wall time at 67 TFLOP/s.  It bounds every kernel's
roofline share from below, whichever kernels run."""

from benchmark.roofline import PEAK_F32_FLOPS


def read(t):
    r = t.roofline
    if t.unit == "step" or not r or not r["flops"] or not t.window_s:
        return None
    return 100.0 * r["flops"] / (t.window_s * PEAK_F32_FLOPS)

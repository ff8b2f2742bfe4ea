"""Share of their roofline that the cell's kernels reach: the least time
the card could take for the traced window's work of those kernels, from
the benchmark's own counts of operations and bytes on the same rays
(``benchmark/roofline.py``), over the kernels' device time from the
profiler."""


def read(t):
    r = t.roofline
    if not r or not r["flops"]:
        return None
    ms = t.kernel_ms(r["kernels"])
    if not ms:
        return None
    return 100.0 * r["least_ms"] / ms

"""Device milliseconds an Adam step of a fit outside the recorder kernel
and the copies: the replay's forward and backward, the loss and Adam, with
each record's glue, from the profiler."""


def read(t):
    if t.unit != "step":
        return None
    g = t.group_ms
    skip = ("kernel_tris_mono", "kernel_spheres", "copy")
    ms = sum(v for k, v in g.items() if k not in skip)
    return ms / t.units if ms else None

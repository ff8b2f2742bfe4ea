"""Device milliseconds an image of the wave path's stream glue: sorts,
gathers and scatters, and the other torch operations between the kernels
(the copies left out), from the profiler.  Nothing where no sort ran."""


def read(t):
    g = t.group_ms
    if t.unit != "image" or not g["sort"]:
        return None
    return (g["sort"] + g["gather_scatter"] + g["other_torch"]) / t.units

"""Share of the untraced window's wall time in which no operation ran on
the device: 1 - busy / window, the device as busy a unit of work (an image,
a step) as in the traced window.  A unit's device time does not depend on
the profiler, the host's time does: the traced window's own share reads
high where the host paces the card.  Where the device is never idle the
two windows' readings can put it a little below 0."""


def read(t):
    u = t.untraced
    if not t.busy_s or not t.units or not u.units or not u.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.units * u.units / u.window_s)

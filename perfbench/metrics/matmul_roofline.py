"""Kernels: the least time the card needs for the dense multiplies of the
requests answered in the profiled window (``harness.work``: 2 n^3
operations at the dtype's data-sheet peak, or the bytes at 3.35 TB/s,
whichever is longer; a quarter each on a 2 x 2 mesh), over the card's busy
time in that window, in percent. Any route is charged the dense count."""


def read(r):
    if r.summary is None or r.summary.busy_s <= 0 or not r.traced:
        return None
    return r.work_bound_s / r.summary.busy_s * 100.0

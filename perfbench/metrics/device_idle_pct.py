"""Device: the share of the profiled window in which nothing ran on the
card (rank 0's card on a mesh), in percent."""


def read(r):
    s = r.summary
    if s is None or s.window_s <= 0:
        return None
    return (1.0 - s.busy_s / s.window_s) * 100.0

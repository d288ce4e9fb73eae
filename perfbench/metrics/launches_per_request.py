"""Chain executor and routes: K1-K3 launches (``kernels.matmul.LAUNCHES``
deltas, plain versions included) per request submitted in the window; the
clients wait for every such request, so the delta covers exactly them."""


def read(r):
    if not r.submitted:
        return None
    return r.counters["launches"] / r.submitted

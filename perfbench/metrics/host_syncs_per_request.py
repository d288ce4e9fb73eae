"""Chain executor, routes and the Markov loop: CUDA runtime waits of the
host on the card (``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` /
``cudaEventSynchronize`` in the profiler's host events, on every thread)
per request answered in the profiled window."""


def read(r):
    if r.summary is None or not r.traced:
        return None
    return r.summary.syncs / len(r.traced)

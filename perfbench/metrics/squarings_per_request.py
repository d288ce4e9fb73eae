"""Markov loop (``core/markov.py`` ``steady_state``): squarings paid per
steady-state answer, from each answer's ``squarings``. Markov cells only."""


def read(r):
    if r.op != "markov" or not r.traced:
        return None
    return sum(r.multiplies) / len(r.multiplies)

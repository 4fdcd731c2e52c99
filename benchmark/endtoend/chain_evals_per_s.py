"""Chains x energy+gradient evaluations completed in the window, over its
wall time: every attempt of the window counted, all of its time."""


def read(w):
    return w.chains * w.n_evals / w.wall_s

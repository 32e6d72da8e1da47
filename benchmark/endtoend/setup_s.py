"""Seconds from the process's start to the end of set-up: imports, the
card, the kernel library (loaded from the checkout's cache, or built),
the programs' build and the warm-up."""


def read(w):
    return w["setup_s"]

"""The device's idle share over the traced prefill segment: 1 - the union of
the kernels' intervals over the segment's length."""

from bench import readers

RANGES = {}


def read(view):
    if view.kind != "prefill":
        return None
    return readers.idle_share(view)

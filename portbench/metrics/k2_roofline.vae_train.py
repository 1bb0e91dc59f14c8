"""K2 (backward_tiles): least time on the launches' inputs over its device time, %."""


def read(t):
    return t.roofline("backward_tiles")

"""K1 (forward_tiles): least time on the launches' inputs over its device time, %."""


def read(t):
    return t.roofline("forward_tiles")

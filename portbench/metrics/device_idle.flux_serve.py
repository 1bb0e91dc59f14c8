"""Share of an untraced unit with no kernel on the device: 1 - the profiler's
device busy time per unit over the untraced units' wall time per unit, %."""


def read(t):
    return t.idle()

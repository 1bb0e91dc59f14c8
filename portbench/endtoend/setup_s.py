"""Process start to the window: imports, inputs and weights, the program's objects, kernel builds, the first steps or requests."""


def read(r):
    return r.setup_s

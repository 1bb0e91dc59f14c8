"""The whole window over the requests completed in it (one client, closed loop: the mean latency), ms."""


def read(r):
    return 1e3 * r.window_s / r.units

"""Samples trained in the window (B x DiT steps completed) over the whole window."""


def read(r):
    return r.units / r.window_s

"""Projection, binning and pair placement of each item's render: the
port's "binning" spans, ms per step."""


def read(t):
    return t.span_ms("binning")

"""The CFG DDIM loop: the port's "dit_sampling" span, ms per request."""


def read(t):
    return t.span_ms("dit_sampling")

"""The flow Euler loop with the FLUX denoiser: the port's "dit_sampling"
span, ms per request."""


def read(t):
    return t.span_ms("dit_sampling")

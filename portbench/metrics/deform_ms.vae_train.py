"""The Gaussians' attribute sampling and deformation to the posed body:
the port's "deform" span, ms per step."""


def read(t):
    return t.span_ms("deform")

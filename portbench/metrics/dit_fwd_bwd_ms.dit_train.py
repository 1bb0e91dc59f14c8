"""The DiT's forward and backward: the port's "dit_fwd_bwd" span, ms per step."""


def read(t):
    return t.span_ms("dit_fwd_bwd")

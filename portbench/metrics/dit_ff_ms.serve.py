"""The DiT blocks' feed-forward over the joined streams (the concatenation
included): the port's "dit_ff" spans, device ms per request."""


def read(t):
    return t.span_ms("dit_ff")

"""The DiT's time and patch embeddings and position tables, their
host-to-device copies included: the port's "dit_embed" spans, device ms
per request."""


def read(t):
    return t.span_ms("dit_embed")

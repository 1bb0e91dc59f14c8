"""The DiT step's frozen encodes: the port's "vae_encode" plus "cond_encode" spans, ms per step."""


def read(t):
    return t.span_ms("vae_encode", "cond_encode")

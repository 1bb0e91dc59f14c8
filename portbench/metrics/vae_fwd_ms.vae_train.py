"""The VAE's forward: the port's "encoder" (3D encoder and bottleneck) plus "decoder" (decoder and heads) spans, ms per step."""


def read(t):
    return t.span_ms("encoder", "decoder")

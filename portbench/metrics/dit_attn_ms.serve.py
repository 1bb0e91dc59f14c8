"""The DiT blocks' joint attention (QKV projections, per-head RMSNorm,
RoPE, SDPA, output projection): the port's "dit_attention" spans, device
ms per request."""


def read(t):
    return t.span_ms("dit_attention")

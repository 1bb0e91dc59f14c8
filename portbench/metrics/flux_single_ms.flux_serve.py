"""FLUX's single-stream blocks (modulation, linear1, QK-norm, RoPE
attention, GELU, linear2 over the joined sequence): the port's
"flux_single" spans, device ms per request."""


def read(t):
    return t.span_ms("flux_single")

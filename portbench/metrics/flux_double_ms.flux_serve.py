"""FLUX's double-stream blocks (per-stream modulation, QKV, QK-norm, joint
RoPE attention, projections and MLPs): the port's "flux_double" spans, one
a block a step, device ms per request."""


def read(t):
    return t.span_ms("flux_double")

"""The sampler's CFG combine and DDIM step in f32: the port's
"ddim_update" spans, device ms per request."""


def read(t):
    return t.span_ms("ddim_update")

"""The G step's autograd backward, clip and AdamW: the port's "backward_optimizer" span, ms per step."""


def read(t):
    return t.span_ms("backward_optimizer")

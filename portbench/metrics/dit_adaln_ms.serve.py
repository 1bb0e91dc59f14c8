"""The DiT blocks' AdaLN-Zero norms and gated residual adds: the port's
"dit_adaln" spans, device ms per request."""


def read(t):
    return t.span_ms("dit_adaln")

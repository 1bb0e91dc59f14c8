"""The FLOPs a request requires (portbench.flux_flops: encoder, one FLUX
forward a step, decode) over the untraced units' time at the bf16 peak, %."""


def read(t):
    return t.mfu()

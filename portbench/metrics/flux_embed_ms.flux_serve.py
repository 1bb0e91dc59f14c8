"""FLUX's stems (latent packing, img_in, txt_in), time, guidance and vector
embedders and the RoPE tables: the port's "flux_embed" spans, device ms
per request."""


def read(t):
    return t.span_ms("flux_embed")

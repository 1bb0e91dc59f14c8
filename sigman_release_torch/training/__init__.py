"""Training loops (the VAE trainer; the DiT trainer is not ported yet)."""

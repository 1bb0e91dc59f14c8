"""Training loops: the VAE trainer and the DiT trainer (with its FSDP and
'model' axis, ``parallel/fsdp.py``)."""

"""Training loops: the VAE trainer and the DiT trainer (with its FSDP and
'model' axis, ``parallel/fsdp.py``), the fit loop and clip they share
(``loop.py``), their state files (``checkpoint.py``) and the multi-rank
cases held against one process (``cases.py``)."""

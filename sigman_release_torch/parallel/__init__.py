"""Data parallelism over ``torch.distributed`` (port of the JAX package's
``parallel/``)."""

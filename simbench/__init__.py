"""The benchmark of the PyTorch and CUDA port, ``repro_torch``: the harness,
its plain reference, the frozen work count and the metric readers.  It
imports nothing of JAX or the JAX package."""

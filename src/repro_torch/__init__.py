"""PyTorch/CUDA port of the simulation stack, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package stands beside
it, imports nothing of it, and holds the same API to the reference's
numbers.  What runs so far is the ``fluid`` backend end to end:
``repro_torch.api.run(scenario, backend="fluid")`` builds the phases,
solves each phase's fluid rates through the hand-written ``cca_step`` and
``steady_scan`` kernels (``repro_torch.kernels``), and returns a
``RunResult``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

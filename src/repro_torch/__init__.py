"""PyTorch/CUDA port of the simulation stack, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package stands beside
it, imports nothing of it, and holds the same API to the reference's
numbers.  What runs so far:

- all six backends of the reference, under its names, so ``compare()``
  spans the whole fidelity ladder;
- the ``packet`` oracle, the ``wormhole`` backend (the oracle under the
  memoizing, fast-forwarding kernel) and the ``hybrid`` backend (adaptive
  packet/flow granularity), on the host, event for event the reference's,
  on the serial loop or the partition-sharded one (``parallel=
  "partitions"``, ``intra_workers``), with ``compare()`` to put backends
  side by side and ``run_many(..., shared_db=True)`` to carry one memo DB
  through a sweep;
- the ``learned`` backend (``repro_torch.learned``): per-flow features from
  the scenario on the host, an MLP fitted with ``torch.autograd`` and served
  on the card;
- the ``fluid`` backend end to end: ``repro_torch.api.run(scenario,
  backend="fluid")`` solves each phase's fluid rates through the
  hand-written ``fluid_scan`` kernel (the phase's whole DCTCP scan and its
  steady detector in one launch);
- the ``analytic`` backend (host-only, exact) and the dense max-min solver
  ``maxmin_rates_torch`` through the ``maxmin`` kernel;
- the architecture zoo's serving path for the dense-attention models
  (``repro_torch.models``, ``python -m repro_torch.launch.serve``), with
  full-sequence attention through the ``flash_attention`` kernel.

Entry points that use the card run on it unless the caller passes
``device="cpu"``; the host-only backends (``packet``, ``wormhole``,
``hybrid``, ``analytic``) take no ``device``.
"""

"""The architecture zoo's serving path: parameter specs, layers, the
decoder-only LM's prefill and decode, and the ``Model`` facade
(:func:`repro_torch.models.api.build_model`)."""

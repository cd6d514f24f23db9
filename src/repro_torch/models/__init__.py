"""The architecture zoo's serving path: parameter specs, layers (attention,
MLA, MLP, MoE), the recurrent mixers, the decoder-only LM's and the
encoder-decoder's prefill and decode, and the ``Model`` facade
(:func:`repro_torch.models.api.build_model`)."""

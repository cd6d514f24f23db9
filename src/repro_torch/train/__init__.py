"""Training substrate: optimizer, train loop, checkpointing, fault
tolerance; gradient compression hooks from :mod:`repro_torch.parallel`."""

from repro_torch.kernels.cca_step.ops import cca_step, cca_step_plain

__all__ = ["cca_step", "cca_step_plain"]

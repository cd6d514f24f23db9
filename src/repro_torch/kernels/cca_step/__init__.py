from repro_torch.kernels.cca_step.ops import (cca_step, cca_step_plain, fluid_scan,
                                              fluid_scan_plain)

__all__ = ["cca_step", "cca_step_plain", "fluid_scan", "fluid_scan_plain"]

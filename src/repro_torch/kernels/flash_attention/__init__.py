from repro_torch.kernels.flash_attention.ops import (attention_backward_plain,
                                                     attention_lse_plain, attention_plain,
                                                     flash_attention, flash_attention_backward)

__all__ = ["attention_backward_plain", "attention_lse_plain", "attention_plain",
           "flash_attention", "flash_attention_backward"]

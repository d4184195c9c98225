from repro_torch.kernels.flash_attention.ops import (  # noqa
    HEAD_DIMS, flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_ref",
           "flash_attention_lse_ref", "flash_attention_bwd_ref", "HEAD_DIMS"]

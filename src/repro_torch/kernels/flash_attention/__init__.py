from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,  # noqa
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

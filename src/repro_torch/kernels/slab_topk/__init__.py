from repro_torch.kernels.slab_topk.ops import (MODES, NOT_PROBED, ROW_PAD,  # noqa
                                               slab_mode, slab_topk)
from repro_torch.kernels.slab_topk.ref import slab_topk_ref  # noqa

__all__ = ["slab_topk", "slab_topk_ref", "slab_mode", "MODES", "NOT_PROBED",
           "ROW_PAD"]

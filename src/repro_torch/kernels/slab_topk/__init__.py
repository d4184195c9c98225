from repro_torch.kernels.slab_topk.ops import NOT_PROBED, ROW_PAD, slab_topk  # noqa
from repro_torch.kernels.slab_topk.ref import slab_topk_ref  # noqa

__all__ = ["slab_topk", "slab_topk_ref", "NOT_PROBED", "ROW_PAD"]

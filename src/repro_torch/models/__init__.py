from repro_torch.models.model import (Model, decode_step, encode,  # noqa
                                      forward, init_params, loss_fn,
                                      param_count, prefill)
from repro_torch.models.cache import KVCache, cache_bytes, init_cache  # noqa
from repro_torch.models.rwkv6 import RwkvCache  # noqa
from repro_torch.models.mamba2 import MambaCache  # noqa

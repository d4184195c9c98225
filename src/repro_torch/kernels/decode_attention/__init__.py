from repro_torch.kernels.decode_attention.ops import (  # noqa
    HEAD_DIMS, DecodeLengths, decode_attention, decode_attention_q8,
    decode_lengths)
from repro_torch.kernels.decode_attention.ref import (  # noqa
    decode_attention_q8_ref, decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref", "decode_attention_q8",
           "decode_attention_q8_ref", "decode_lengths", "DecodeLengths",
           "HEAD_DIMS"]

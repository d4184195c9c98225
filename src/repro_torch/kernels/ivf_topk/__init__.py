from repro_torch.kernels.ivf_topk.ops import topk_ip  # noqa

"""Train a small LM (any assigned architecture) on synthetic data with the
PyTorch port and watch the loss fall: the port's ``make_train_step`` on
one fixed batch, which the model must overfit.  Runs on the card;
``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py --arch olmoe-1b-7b --steps 100
(see also: python -m repro_torch.launch.train for the launcher with
checkpointing)
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.model import init_params
from repro_torch.train.train_step import make_train_step, train_state_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32

    cfg = configs.get_config(args.arch).reduced()
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"pattern={cfg.block_pattern}")
    state = train_state_init(init_params(cfg, seed=0, device=args.device))
    step = make_train_step(cfg, peak_lr=3e-3, total_steps=args.steps)

    # fixed tiny corpus -> the model must overfit (loss -> small)
    rng = np.random.default_rng(0)
    data = rng.integers(0, cfg.vocab_size, size=(args.batch, args.seq + 1))
    dev = state.model.device
    batch = {"tokens": torch.as_tensor(data[:, :-1], dtype=torch.int32,
                                       device=dev),
             "labels": torch.as_tensor(data[:, 1:], dtype=torch.int32,
                                       device=dev)}
    if cfg.use_mrope:
        pos = torch.arange(args.seq, device=dev).expand(args.batch, args.seq)
        batch["positions"] = pos.expand(3, args.batch, args.seq)
    if cfg.embedding_inputs:
        batch["embeds"] = torch.as_tensor(
            rng.standard_normal((args.batch, args.seq, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=dev)
        batch.pop("tokens")

    first = None
    for i in range(args.steps):
        state, m = step(state, batch)
        if first is None:
            first = m["loss"]
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={m['loss']:.4f} "
                  f"|g|={m['grad_norm']:.2f}")
    print(f"\nloss {first:.3f} -> {m['loss']:.3f} "
          f"({'OVERFIT OK' if m['loss'] < first * 0.7 else 'check'})")
    return first, m["loss"]


if __name__ == "__main__":
    main()

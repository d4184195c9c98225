"""Training launcher of the port.

Mirrors ``repro.launch.train`` (same flags and printout): synthetic LM
data, ``make_train_step``, and a checkpoint of the parameters at the end
in the JAX package's format.  There is no mesh: the one card is the
device (``--device cpu`` runs on the CPU).  Without ``--full-size`` it
trains the config's ``.reduced()`` variant.

  python -m repro_torch.launch.train --arch stablelm-1.6b --device cpu
  python -m repro_torch.launch.train --arch olmoe-1b-7b --steps 50 --batch 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.train_step import make_train_step, train_state_init


def synthetic_lm_batch(rng: np.random.Generator, cfg, batch: int, seq: int,
                       device=None):
    """Markov-ish synthetic tokens: learnable structure, not pure noise.
    The reference's batch, drawn from ``rng`` in the same order: tokens
    and labels (B, seq - 1), M-RoPE positions (3, B, seq - 1), and for an
    embedding-input config ``embeds`` (B, seq - 1, d) in place of the
    tokens; on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    base = rng.integers(0, cfg.vocab_size, size=(batch, 1))
    drift = rng.integers(-3, 4, size=(batch, seq)).cumsum(axis=1)
    toks = (base + np.abs(drift)) % cfg.vocab_size
    as_t = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype,
                                            device=dev)
    b = {"tokens": as_t(toks[:, :-1], torch.int32),
         "labels": as_t(toks[:, 1:], torch.int32)}
    if cfg.use_mrope:
        pos = torch.arange(seq - 1, device=dev).expand(batch, seq - 1)
        b["positions"] = pos.expand(3, batch, seq - 1)
    if cfg.embedding_inputs:
        emb = rng.standard_normal((batch, seq - 1, cfg.d_model)) * 0.02
        b["embeds"] = as_t(emb, torch.float32)
        del b["tokens"]
    return b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config, not the smoke one")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32

    cfg = configs.get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    rng = np.random.default_rng(0)
    state = train_state_init(init_params(cfg, seed=0, device=args.device))
    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps)
    t0 = time.time()
    for i in range(args.steps):
        batch = synthetic_lm_batch(rng, cfg, args.batch, args.seq + 1,
                                   device=args.device)
        state, m = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"aux={m['aux']:.4f} |g|={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} ({time.time()-t0:.1f}s)", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.model)
        print(f"saved params -> {args.checkpoint}")
    print(f"final loss {m['loss']:.4f}")
    return m["loss"]


if __name__ == "__main__":
    main()

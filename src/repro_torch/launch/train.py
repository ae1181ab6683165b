"""Training launcher of the port.

Smoke scale (default): trains a reduced variant of --arch on synthetic
LM data for --steps steps, committing versioned checkpoints to the
WeightStore (the paper's storage plane is the checkpoint substrate).
``--full-config`` trains the full config on one card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 30 --store /tmp/weights.db --checkpoint-every 10 --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import LMDataConfig, lm_batches
from repro_torch.training import OptimizerConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None, help="WeightStore path for checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not smoke) config")
    ap.add_argument("--device", default="cuda", help="torch device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_variant(cfg)
    device = torch.device(args.device)
    print(f"training {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"vocab {cfg.vocab_size} on {device.type}")

    data = lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed,
    ))
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    store = WeightStore(args.store) if args.store else None
    params, history = train_loop(
        cfg, ocfg, data, args.steps, seed=args.seed,
        store=store, store_model=cfg.name,
        checkpoint_every=args.checkpoint_every, device=device,
    )
    first, last = history["loss"][0], history["loss"][-1]
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if store is not None:
        print("checkpoints:", [h["id"] for h in store.history(cfg.name)])
        store.close()


if __name__ == "__main__":
    main()

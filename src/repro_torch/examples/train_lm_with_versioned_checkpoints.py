"""End-to-end LM training on the port: train a small LM for a few hundred
steps with the WeightStore as the checkpoint plane, then roll back to
the first checkpoint.

The arch is a reduced qwen2.5 (same family; GQA + SwiGLU + QKV-bias); the
data is the structured synthetic stream (models actually learn it).
Every N steps the trainer commits a *delta* checkpoint — unchanged weights
are stored once across all versions (paper §3.4).  On the card each step
replays the training step's CUDA graph.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_with_versioned_checkpoints \
          [--steps 300] [--device cpu]
"""
from __future__ import annotations

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import LMDataConfig, lm_batches
from repro_torch.examples import launches, parse, parser
from repro_torch.training import OptimizerConfig, train_loop


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2.5-3b")
    args = parse(ap, argv)

    cfg = smoke_variant(get_config(args.arch)).replace(vocab_size=512)
    store = WeightStore(":memory:", row_limit=1 << 30)  # row mode for clarity
    store.register_model(cfg.name, cfg.arch_type)

    data = lm_batches(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                   batch_size=8, seed=0))
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    _, history = train_loop(
        cfg, ocfg, data, args.steps, store=store, store_model=cfg.name,
        checkpoint_every=max(args.steps // 4, 1), log_every=25, device=args.device,
    )
    losses = history["loss"]
    learned = losses[-1] < losses[0] - 0.2
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'LEARNED' if learned else 'check data/config'})")

    hist = store.history(cfg.name)
    checkpoints = [h["id"] for h in hist]
    print(f"checkpoints: {checkpoints}")
    sizes = store.storage_bytes(cfg.name)
    print(f"store: {sizes['weight_rows']} rows / "
          f"{(sizes['payload']) / 1e6:.1f} MB payload for {len(hist)} versions")

    # rollback demo (paper §3.4): repoint production to the first checkpoint
    store.rollback(cfg.name, hist[0]["id"])
    production = store.production_version(cfg.name)
    print(f"rolled back production -> v{production}")
    store.close()
    return dict(first_loss=losses[0], last_loss=losses[-1], learned=learned,
                checkpoints=checkpoints, weight_rows=sizes["weight_rows"],
                payload=sizes["payload"], versions=len(hist), production=production,
                launches=launches())


if __name__ == "__main__":
    main()

"""Serving launcher of the port: licensed batched generation on one card.

Random-initializes the model from ``--seed`` (the repository has no
checkpoint), builds the tier ladder (``full`` plus ``free``, which masks
|w| < 0.01 everywhere), and drains a batch of requests per tier through
the continuous-batching ``LicensedGateway`` — one stored weight set
serving several accuracy tiers (§3.5).  ``--int8-views`` serves from one
int8 store with each tier's view built by the fused masked-dequant.

The observability layer rides along: ``--prometheus-out`` dumps the
Prometheus text exposition, ``--trace-out`` the whole-gateway Chrome
trace (load it in Perfetto / chrome://tracing), ``--audit-out`` the
licensing audit stream as JSONL; ``-`` prints to stdout.
``--no-telemetry`` records nothing.

Example (on the card, full width and depth):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --full-config --tiers full,free --prompt-len 32 --new-tokens 8 \
      --prometheus-out - --trace-out trace.json --audit-out audit.jsonl
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.core.licensing import FULL_TIER, LicenseTier
from repro_torch.models import init_params
from repro_torch.serving import LicensedGateway


def _dump(dest: str, text: str, label: str) -> None:
    if dest == "-":
        sys.stdout.write(text if text.endswith("\n") else text + "\n")
    else:
        with open(dest, "w") as f:
            f.write(text)
        print(f"wrote {label} to {dest}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--tiers", default="full,free")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--int8-views", action="store_true",
                    help="serve from one int8 store with materialized "
                         "per-tier views (the fused masked-dequant)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs the plain versions "
                         "of the kernels")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable tracing/metrics/audit recording")
    ap.add_argument("--prometheus-out", default=None, metavar="PATH",
                    help="dump Prometheus text exposition ('-' = stdout)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump Chrome trace_event JSON ('-' = stdout)")
    ap.add_argument("--audit-out", default=None, metavar="PATH",
                    help="dump licensing audit JSONL ('-' = stdout)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_variant(cfg)
    device = torch.device(args.device)
    params = init_params(cfg, seed=args.seed, device=device)
    tiers = {"full": FULL_TIER,
             "free": LicenseTier(name="free", masks={"*": ((0.0, 0.01),)})}
    gw = LicensedGateway(cfg, params, tiers=tiers, max_batch=args.batch,
                         max_prompt=args.prompt_len,
                         max_new_cap=args.new_tokens,
                         quantized=args.int8_views,
                         materialize_int8_views=args.int8_views,
                         telemetry=not args.no_telemetry, device=device)

    rng = np.random.default_rng(args.seed)
    for tier in args.tiers.split(","):
        reqs = [gw.submit(rng.integers(0, cfg.vocab_size, args.prompt_len,
                                       dtype=np.int32),
                          max_new_tokens=args.new_tokens, license=tier,
                          seed=args.seed)
                for _ in range(args.batch)]
        gw.run()
        print(f"tier={tier}: " + " | ".join(str(r.out_tokens) for r in reqs[:2]))

    m = gw.metrics()
    print(f"served {m['completed']} requests, {m['tokens_generated']} tokens "
          f"on {device}; latency p99 {m.get('latency_p99_ms', 0.0):.1f}ms, "
          f"ttft p99 {m['latency']['ttft_s']['p99'] * 1e3:.1f}ms")
    if args.prometheus_out:
        _dump(args.prometheus_out, gw.render_prometheus(), "Prometheus text")
    if args.trace_out:
        _dump(args.trace_out, gw.chrome_trace(), "Chrome trace")
    if args.audit_out:
        _dump(args.audit_out, gw.audit.render_jsonl(), "audit JSONL")


if __name__ == "__main__":
    main()

"""Synthetic data pipelines (no external corpora), numpy only.

Counterpart of ``repro.data.pipeline``, kept as a copy: the same seed
gives the same arrays in both packages.

``lm_batches`` generates structured pseudo-language streams: a Zipfian
unigram mixture with Markov bigram structure, so models actually *learn*
(loss decreases) rather than memorizing noise.

``classification_data`` builds the Gaussian-cluster task used for the
paper-scale MLP experiments (98%-accuracy freemium example, §3.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 1


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def lm_batches(cfg: LMDataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of {tokens, labels} with next-token labels."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    base = _zipf_probs(min(v, 4096), cfg.zipf_a)
    support = min(v, 4096)
    # sparse bigram transition: each token prefers a few successors
    n_next = 8
    nxt = rng.integers(0, support, size=(support, n_next))
    while True:
        toks = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(support, size=cfg.batch_size, p=base)
        for t in range(cfg.seq_len):
            prev = toks[:, t]
            use_markov = rng.random(cfg.batch_size) < 0.7
            succ = nxt[prev, rng.integers(0, n_next, cfg.batch_size)]
            rand = rng.choice(support, size=cfg.batch_size, p=base)
            toks[:, t + 1] = np.where(use_markov, succ, rand)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def classification_data(
    n: int, in_dim: int, num_classes: int, *, seed: int = 0,
    spread: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian clusters (one per class) — separable to ~98% like the
    paper's 3-layer-MLP example.  Default spread is dimension-normalized
    so the ~98% regime holds for any in_dim."""
    if spread is None:
        spread = 7.5 / np.sqrt(in_dim)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, in_dim)) * spread
    y = rng.integers(0, num_classes, size=n)
    x = centers[y] + rng.standard_normal((n, in_dim))
    return x.astype(np.float32), y.astype(np.int32)

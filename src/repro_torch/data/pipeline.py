"""Deterministic, step-addressed data pipelines.

Port of ``src/repro/data/pipeline.py``.  The contract is the reference's:
batch ``i`` is a pure function of ``(seed, i)``, so resuming after a crash
or a preemption is ``pipeline.batch(step)`` with no iterator state, and
``batch_slice`` cuts one worker's rows out of the global batch.

Difference from the reference (ROADMAP queue 3): the reference draws with
``jax.random`` threefry keys folded with the step; the port draws from a
numpy generator seeded with ``(seed, step)``.  The distribution is the
same (a Zipf-ish marginal from an exponential transform of uniforms, every
other token, at random, its left neighbour + 1, labels shifted left with
``-1`` last), the streams are not bit-equal, so tests compare the two
packages on the same numpy batches, never on their pipelines.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenPipeline:
    """Synthetic LM token stream with Zipf-ish marginals and a local
    bigram structure (so losses move when training works).  Batches are
    int64 tensors on ``device``."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, device="cpu"):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.device = device

    def batch(self, step: int, *, batch_slice: slice | None = None):
        """Full global batch (or a slice of it) for ``step``.  Pure."""
        toks = self._gen(np.random.default_rng([self.seed, step]),
                         self.global_batch)
        if batch_slice is not None:
            toks = toks[batch_slice]
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int64)], 1)
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}

    def _gen(self, rng: np.random.Generator, b: int) -> np.ndarray:
        # Zipf-ish marginal via exponential transform of uniforms
        u = rng.uniform(1e-6, 1.0, (b, self.seq_len)).astype(np.float32)
        ranks = np.floor(np.exp(np.log(np.float32(self.vocab)) * u)) - 1
        toks = ranks.astype(np.int64) % self.vocab
        # local structure: every other token repeats its neighbour + 1
        rep = rng.random((b, self.seq_len)) < 0.5
        shifted = np.roll(toks, 1, axis=1)
        return np.where(rep, (shifted + 1) % self.vocab, toks)


def synthetic_embeds(seed: int, batch: int, seq_len: int, d_model: int,
                     dtype=torch.float32, device="cpu"):
    """Frontend-stub embeddings for [audio]/[vlm] archs (precomputed
    frame/patch embeddings): standard normal from a generator seeded with
    ``seed`` (the reference takes a ``jax.random`` key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((batch, seq_len, d_model), generator=gen,
                       dtype=torch.float32, device=device).to(dtype)

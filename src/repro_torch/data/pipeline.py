"""Synthetic token pipeline: deterministic per (seed, step, host-shard),
so (a) restarts reproduce the exact byte stream (checkpoint/restart
correctness is testable), and (b) elastic re-scales re-partition the same
global stream across a different host count (skip-ahead by global step).

The "documents" are Zipf-ish token draws with markov-ish structure so the
LM loss actually decreases during the example training runs.

Copy of ``repro.data.pipeline``, which the port may not import: the same
batches, bit for bit (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    step: int = 0

    def __post_init__(self) -> None:
        assert self.global_batch % self.n_hosts == 0
        self.local_batch = self.global_batch // self.n_hosts
        # fixed "unigram" structure shared by every host
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._bigram_shift = rng.integers(1, self.vocab, size=257)

    def _batch_rng(self, step: int, sample: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + sample)

    def next_batch(self) -> dict:
        """dict(tokens, labels) int32 [local_batch, seq_len]."""
        out = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            gsample = self.host_id * self.local_batch + i
            rng = self._batch_rng(self.step, gsample)
            toks = rng.choice(self.vocab, size=self.seq_len + 1, p=self._probs)
            # inject learnable bigram structure
            mask = rng.random(self.seq_len + 1) < 0.5
            shifted = (toks + self._bigram_shift[toks % 257]) % self.vocab
            toks = np.where(mask, np.roll(shifted, 1), toks)
            out[i] = toks
        self.step += 1
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    # ------------------------------------------------------------------ #
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict, n_hosts: int | None = None,
                host_id: int | None = None) -> None:
        """Resume; optionally re-partition over a different host count
        (elastic restart): the global stream continues identically because
        sample RNG keys are global (step, global_sample)."""
        self.step = state["step"]
        assert state["seed"] == self.seed, "seed mismatch on restore"
        if n_hosts is not None:
            assert self.global_batch % n_hosts == 0
            self.n_hosts = n_hosts
            self.host_id = host_id if host_id is not None else 0
            self.local_batch = self.global_batch // n_hosts

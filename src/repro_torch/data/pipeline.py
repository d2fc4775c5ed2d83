"""Deterministic, checkpointable synthetic data pipeline (a copy of the JAX
package's `data/pipeline.py`, numpy only).

A seeded Zipf-ish token stream with enough structure for a ~100M model to
show a falling loss curve (local n-gram correlations + copy spans). The
pipeline state is exactly (seed, step): it lives in the checkpoint, so a
restart resumes the stream bit-exactly, and batches are generated on the
host whatever device the model trains on. Every batch and every `state()`
is bitwise the JAX package's for the same config and step.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.3
    copy_prob: float = 0.3
    copy_span: int = 16


class SyntheticLM:
    """state = (config, step); batch(step) is a pure function of both."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = int(step)
        # A fixed Zipf table (the "vocabulary distribution").
        rs = np.random.RandomState(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._p = p / p.sum()
        self._perm = rs.permutation(cfg.vocab)

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict) -> "SyntheticLM":
        if state["seed"] != cfg.seed:
            raise ValueError(f"data stream seed mismatch: checkpoint {state['seed']}, config {cfg.seed}")
        return cls(cfg, step=state["step"])

    def next_batch(self) -> np.ndarray:
        """[global_batch, seq_len] int32, deterministic in (seed, step)."""
        cfg = self.cfg
        rs = np.random.RandomState((cfg.seed * 1_000_003 + self.step) % 2**31)
        toks = self._perm[
            rs.choice(cfg.vocab, size=(cfg.global_batch, cfg.seq_len), p=self._p)
        ].astype(np.int32)
        # Copy spans: learnable structure (induction heads etc.).
        n_spans = int(cfg.copy_prob * cfg.global_batch)
        for i in rs.choice(cfg.global_batch, size=n_spans, replace=False):
            span = cfg.copy_span
            if cfg.seq_len > 4 * span:
                src = rs.randint(0, cfg.seq_len // 2 - span)
                dst = rs.randint(cfg.seq_len // 2, cfg.seq_len - span)
                toks[i, dst : dst + span] = toks[i, src : src + span]
        self.step += 1
        return toks


def make_pipeline(cfg: DataConfig, state: dict | None = None) -> SyntheticLM:
    if state is not None:
        return SyntheticLM.restore(cfg, state)
    return SyntheticLM(cfg)

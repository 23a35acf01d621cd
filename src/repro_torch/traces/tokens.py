"""Token-data pipeline for LM training (substrate for repro_torch.train).

The port's copy of ``repro.traces.tokens``, kept numpy: the stream draws
from numpy's generators, so the port's batches are bitwise the JAX
package's for the same (seed, step). Callers convert to tensors at the
call site (``repro_torch.launch.train``).

Deterministic synthetic corpus with realistic statistics: Zipfian unigram
distribution plus a first-order Markov "phrase" structure so the loss curve
is non-trivial (a model can actually learn bigram structure). Documents are
packed into fixed-length sequences with EOS separators and per-token loss
masks — the standard production packing scheme — and served by a host-side
loader that yields globally-consistent shards per data-parallel host.

Everything is seeded: step `s` of loader `seed` is reproducible across
restarts (checkpoint/restart tests rely on this).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    zipf_a: float = 1.2          # Zipf exponent for unigram draws
    mean_doc_len: int = 256      # geometric document lengths
    markov_blend: float = 0.5    # weight of the bigram component


class SyntheticTokenStream:
    """Deterministic, restartable synthetic token stream.

    The stream for (seed, step) is a pure function — resuming from a
    checkpointed ``step`` reproduces the exact batches a non-failed run
    would have seen (asserted in tests/test_checkpoint.py and, for the port,
    tests/test_torch_checkpoint.py).
    """

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = ranks ** (-cfg.zipf_a)
        self._unigram /= self._unigram.sum()
        # A sparse-ish random bigram kernel: each token prefers a small set
        # of successors (phrase structure the model can learn).
        succ = base.integers(0, v, size=(v, 4))
        self._succ = succ.astype(np.int64)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Materialize the (global_batch, seq_len) batch for ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Unigram draws for the whole batch.
        uni = rng.choice(v, size=(b, s), p=self._unigram)
        # Markov pass: with prob markov_blend, token t+1 is a preferred
        # successor of token t. Vectorized over batch, scanned over seq.
        out = uni.copy()
        use_succ = rng.random((b, s)) < cfg.markov_blend
        pick = rng.integers(0, self._succ.shape[1], size=(b, s))
        for t in range(1, s):
            succ_t = self._succ[out[:, t - 1], pick[:, t]]
            out[:, t] = np.where(use_succ[:, t], succ_t, out[:, t])
        # Document boundaries: geometric lengths -> EOS + loss-mask reset.
        boundary = rng.random((b, s)) < (1.0 / cfg.mean_doc_len)
        out = np.where(boundary, cfg.eos_id, out)
        mask = np.ones((b, s), np.float32)
        return {
            "tokens": out.astype(np.int32),
            "loss_mask": mask,
            "segment_starts": boundary,
        }

    def shard_iterator(
        self, host_index: int, host_count: int, start_step: int = 0
    ) -> Iterator[dict[str, np.ndarray]]:
        """Host-sharded iterator: host h sees rows [h::host_count] of each batch.

        All hosts draw the same global batch (seeded) and slice their shard —
        the idiom that keeps multi-host data loading consistent without a
        central dispatcher.
        """
        if self.cfg.global_batch % host_count:
            raise ValueError("global_batch must divide evenly across hosts")
        step = start_step
        while True:
            full = self.batch(step)
            yield {k: val[host_index::host_count] for k, val in full.items()}
            step += 1


def lm_inputs(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Shift a packed batch into (inputs, labels, mask) for next-token loss."""
    toks = batch["tokens"]
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "loss_mask": batch["loss_mask"][:, 1:],
    }

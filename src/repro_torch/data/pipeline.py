"""Deterministic data pipeline as a MISO *source cell* (a port of
``repro/data/pipeline.py``).

The source cell's transition makes the next batch on the device from a
PRNG key carried in its state: pure and replayable, so a restored
checkpoint regenerates the same stream.  The keys and draws are
``repro_torch.prng``'s, bitwise ``jax.random``'s, so both packages make
the same batches from the same config.

Two streams:
  * ``bigram``  -- tokens walked through a fixed random bigram table
    (logits ``2 * normal``), so an LM can drive its loss well below the
    unigram entropy.  The table is never made whole: each step draws
    the rows of the current tokens alone (``prng.normal_rows``), which is
    the same bits (the table of a 92544-token vocabulary is 34 GB).
  * ``uniform`` -- i.i.d. tokens (throughput benchmarking).

A host-side byte-corpus loader is included for the quickstart example.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import prng
from ..core import CellType
from ..core.cell import scan_steps
from ..core.executor import resolve_device

@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    vocab: int
    kind: str = "bigram"  # bigram | uniform
    n_codebooks: int = 1
    seed: int = 0


def _table_key(cfg: DataConfig, device) -> torch.Tensor:
    return prng.PRNGKey(cfg.seed * 7919 + 13, device)


def bigram_rows(cfg: DataConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the bigram logits table (vocab, vocab):
    (*tokens.shape, vocab) float32."""
    return prng.normal_rows(_table_key(cfg, tokens.device), cfg.vocab, tokens) * 2.0


def _walk_step(table_key: torch.Tensor, key: torch.Tensor, tok: torch.Tensor, vocab: int):
    """One step of the bigram walk: ``categorical(key, table[tok])``."""
    rows = prng.normal_rows(table_key, vocab, tok) * 2.0
    return torch.argmax(prng.gumbel(key, rows.shape) + rows, dim=-1).to(torch.int32)


class _GraphedWalkStep:
    """``_walk_step`` captured once in a CUDA graph for one (shape, vocab,
    device) and replayed: eager, each of its few hundred elementwise ops a
    step is a launch from the host, and a batch is hundreds of steps; a
    replay hands the card the whole step at once (JAX's scan body is one
    compiled program).  The graph runs the eager code's own kernels, so
    it makes the same tokens."""

    _cache: dict = {}

    def __init__(self, shape, vocab: int, device):
        self.key = torch.zeros((2,), dtype=torch.int32, device=device)
        self.table_key = torch.zeros((2,), dtype=torch.int32, device=device)
        self.tok = torch.zeros(shape, dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up outside the capture
            _walk_step(self.table_key, self.key, self.tok, vocab)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _walk_step(self.table_key, self.key, self.tok, vocab)

    @classmethod
    def get(cls, shape, vocab: int, device) -> "_GraphedWalkStep":
        k = (tuple(shape), vocab, str(device))
        if k not in cls._cache:
            cls._cache[k] = cls(shape, vocab, device)
        return cls._cache[k]

    def walk(self, table_key, keys, tok) -> list:
        self.table_key.copy_(table_key)
        self.tok.copy_(tok)
        toks = []
        for i in range(keys.shape[0]):
            self.key.copy_(keys[i])
            self.graph.replay()
            toks.append(self.out.clone())
            self.tok.copy_(self.out)
        return toks


def sample_batch(cfg: DataConfig, key: torch.Tensor) -> torch.Tensor:
    """One batch (B, S[, K]) int32 on ``key``'s device."""
    shape = (cfg.batch, cfg.seq_len)
    if cfg.n_codebooks > 1:
        shape = shape + (cfg.n_codebooks,)
    if cfg.kind == "uniform":
        return prng.randint(key, shape, 0, cfg.vocab)
    if cfg.kind != "bigram":
        raise ValueError(f"unknown data kind {cfg.kind!r}")
    k0, k1 = prng.split(key)
    tok = prng.randint(k0, shape[:1] + shape[2:], 0, cfg.vocab)
    keys = prng.split(k1, cfg.seq_len - 1).view(torch.int32)
    table_key = _table_key(cfg, key.device).view(torch.int32)
    if key.device.type == "cuda":
        walk = _GraphedWalkStep.get(tok.shape, cfg.vocab, key.device)
        return torch.stack([tok] + walk.walk(table_key, keys, tok), dim=1)
    toks = scan_steps(lambda i, t: _walk_step(table_key, keys[i], t, cfg.vocab), tok,
                      cfg.seq_len - 1)
    return torch.stack([tok] + toks, dim=1)


def data_cell(cfg: DataConfig, name: str = "data") -> CellType:
    """MISO source cell: state = {tokens, key}; each transition emits the
    next deterministic batch.  The init generator is not used: the
    stream keys off ``cfg.seed`` alone, as in the JAX package."""

    def init(generator, device):
        k = prng.fold_in(prng.PRNGKey(cfg.seed, device), 1)
        return {"tokens": sample_batch(cfg, k), "key": k}

    def transition(prev):
        k = prng.split(prev[name]["key"])[0]
        return {"tokens": sample_batch(cfg, k), "key": k}

    return CellType(name=name, init=init, transition=transition, instances=cfg.batch)


#: the largest vocabulary whose whole bigram table ``bigram_optimal_xent``
#: makes (1 GiB of f32)
MAX_XENT_VOCAB = 16384


def bigram_optimal_xent(cfg: DataConfig, n: int = 65536, *, device="cuda") -> float:
    """Entropy rate of the bigram stream (the achievable loss floor).
    Makes the whole table, so refuses vocabularies above
    ``MAX_XENT_VOCAB``."""
    if cfg.vocab > MAX_XENT_VOCAB:
        raise ValueError(
            f"bigram_optimal_xent makes the whole {cfg.vocab}^2 table; "
            f"vocab above {MAX_XENT_VOCAB} is refused")
    dev = resolve_device(device)
    table = bigram_rows(cfg, torch.arange(cfg.vocab, device=dev))
    logp = torch.log_softmax(table, dim=-1)
    p = torch.exp(logp)
    cond_ent = -torch.sum(p * logp, dim=-1)
    # stationary distribution by power iteration
    pi = torch.ones((cfg.vocab,), device=dev) / cfg.vocab
    for _ in range(50):
        pi = pi @ p
        pi = pi / torch.sum(pi)
    return float(torch.sum(pi * cond_ent))


# --------------------------------------------------------------------------
# host-side byte corpus (quickstart)
# --------------------------------------------------------------------------
def byte_corpus(text: Optional[str] = None) -> np.ndarray:
    if text is None:
        # a tiny synthetic "corpus" with learnable structure
        rng = np.random.default_rng(0)
        words = ["miso", "cell", "state", "transition", "replica", "vote",
                 "pod", "mesh", "shard", "scan", "fault", "tolerant"]
        text = " ".join(rng.choice(words, 200_000))
    return np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)


def host_batches(corpus: np.ndarray, batch: int, seq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(corpus) - seq - 1
    while True:
        idx = rng.integers(0, n, batch)
        yield np.stack([corpus[i:i + seq] for i in idx])

"""The data source cell (``repro_torch.data.pipeline``) against the JAX
package's: batches BITWISE over several data-cell steps for the uniform
and bigram streams and for 4 codebooks, the keys carried in the state
bitwise, the vision stub (``lm_cells.make_data_cell``) within 1e-6, and
``bigram_optimal_xent`` within 1e-5 relative."""

import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.data import pipeline as JP
from repro.models import lm_cells as JL
from repro_torch import prng
from repro_torch.configs import get_reduced as tget
from repro_torch.data import pipeline as TP
from repro_torch.models import lm_cells as TL
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

STEPS = 4


def key_words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("kind,codebooks,seed", [
    ("uniform", 1, 0), ("bigram", 1, 0), ("bigram", 1, 3), ("uniform", 4, 1), ("bigram", 4, 2),
])
def test_batches_bitwise_over_data_cell_steps(kind, codebooks, seed):
    kw = dict(batch=3, seq_len=24, vocab=256, kind=kind, n_codebooks=codebooks, seed=seed)
    jcell, tcell = JP.data_cell(JP.DataConfig(**kw)), TP.data_cell(TP.DataConfig(**kw))
    js, ts = jcell.init(jax.random.PRNGKey(0)), tcell.init(torch.Generator(), "cpu")
    for step in range(STEPS):
        a, b = np.asarray(js["tokens"]), ts["tokens"].numpy()
        assert b.dtype == np.int32 and a.shape == b.shape, step
        assert (a == b).all(), f"step {step}: batches differ"
        assert (np.asarray(js["key"]) == key_words(ts["key"])).all(), step
        js, ts = jcell.transition({"data": js}), tcell.transition({"data": ts})


def test_bigram_rows_are_the_jax_table():
    """The rows the walk draws alone are the JAX package's whole table's."""
    cfg = TP.DataConfig(batch=1, seq_len=2, vocab=300, seed=4)
    table = np.asarray(JP._bigram_logits(300, 4))
    toks = torch.tensor([[0, 299], [17, 17]])
    got = TP.bigram_rows(cfg, toks).numpy()
    assert (got.view(np.int32) == table[toks.numpy()].view(np.int32)).all()


def test_sample_batch_from_any_key():
    for i in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(9), i)
        tk = torch.from_numpy(np.asarray(jk).view(np.int32).copy()).view(torch.uint32)
        for kind in ("bigram", "uniform"):
            kw = dict(batch=2, seq_len=9, vocab=50, kind=kind)
            a = JP.sample_batch(JP.DataConfig(**kw), jk)
            assert (np.asarray(a) == TP.sample_batch(TP.DataConfig(**kw), tk).numpy()).all()


def test_the_init_generator_is_not_used():
    """The stream keys off ``cfg.seed`` alone, as in JAX (:71)."""
    cell = TP.data_cell(TP.DataConfig(batch=2, seq_len=8, vocab=64))
    a = cell.init(torch.Generator().manual_seed(1), "cpu")
    b = cell.init(torch.Generator().manual_seed(2), "cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["key"], b["key"])
    assert a["key"].dtype == torch.uint32


def test_vision_stub_within_1e6():
    """qwen2-vl's data cell also carries 0.02 * normal(fold_in(key, 77))
    in the compute dtype (f32 here)."""
    jcfg = dc.replace(jget("qwen2-vl-7b"), dtype="float32")
    tcfg = dc.replace(tget("qwen2-vl-7b"), dtype="float32")
    kw = dict(batch=2, seq_len=16, vocab=jcfg.vocab_size, kind="uniform")
    jcell = JL.make_data_cell(jcfg, JL.TrainConfig(data=JP.DataConfig(**kw)))
    tcell = TL.make_data_cell(tcfg, TL.TrainConfig(data=TP.DataConfig(**kw)))
    js, ts = jcell.init(jax.random.PRNGKey(0)), tcell.init(torch.Generator(), "cpu")
    for _ in range(2):
        a, b = np.asarray(js["vision_embeds"]), ts["vision_embeds"].numpy()
        assert a.shape == b.shape == (2, jcfg.n_vision_tokens, jcfg.d_model)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        assert (np.asarray(js["tokens"]) == ts["tokens"].numpy()).all()
        js, ts = jcell.transition({"data": js}), tcell.transition({"data": ts})


@pytest.mark.parametrize("vocab,seed", [(64, 0), (256, 2)])
def test_bigram_optimal_xent_within_1e5(vocab, seed):
    kw = dict(batch=1, seq_len=2, vocab=vocab, seed=seed)
    a = JP.bigram_optimal_xent(JP.DataConfig(**kw))
    b = TP.bigram_optimal_xent(TP.DataConfig(**kw), device="cpu")
    assert abs(a - b) <= 1e-5 * abs(a)


def test_bigram_optimal_xent_refuses_the_whole_large_table():
    with pytest.raises(ValueError, match="refused"):
        TP.bigram_optimal_xent(TP.DataConfig(batch=1, seq_len=2, vocab=92544), device="cpu")


def test_byte_corpus_and_host_batches_are_the_jax_packages():
    assert (TP.byte_corpus() == JP.byte_corpus()).all()
    corpus = TP.byte_corpus("miso cells replicate " * 20)
    for a, b in zip(TP.host_batches(corpus, 3, 8, seed=5), JP.host_batches(corpus, 3, 8, seed=5)):
        assert (a == b).all()
        break


def test_keys_are_prng_keys():
    """The state's key leaf is JAX's uint32 (2,) raw key."""
    st = TP.data_cell(TP.DataConfig(batch=1, seq_len=4, vocab=16)).init(None, "cpu")
    want = prng.fold_in(prng.PRNGKey(0), 1)
    assert st["key"].shape == (2,) and torch.equal(st["key"], want)

"""Sharded decode against the JAX package's, case ``seq_sharded`` of
``tests/test_decode_spmd.py``'s child: internlm2 with 2 kv heads over a
model axis of 4, so the 32-lane cache is sequence-sharded (8 lanes a
member) and each member's partial softmax is combined by the
flash-decoding collectives (the child, the port's runs and the gates are
``test_torch_decode_spmd.py``'s).  Two cases with no JAX test, held
against the port's unsharded decode: a windowed ring (h2o-danube,
window 32, a 40-token prompt that wraps it, 8 steps that write across
the members' lane ranges) and inactive slots (the gated rows' cache and
position stay bitwise, one of them an empty slot with no valid lane)."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_reduced as tget
from repro_torch.distributed.sharding import unshard
from repro_torch.models import transformer as T
from repro_torch.models.lm_cells import install_prefill, place_cache, place_params
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_map
from test_torch_decode_spmd import (check_caches, check_greedy, check_logits, mesh_ctx,
                                    port_runs, run_child)

cap_threads_for_xdist()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_res = run_child("seq_sharded", tmp_path_factory)
    return jax_res, port_runs("seq_sharded", jax_res)


def test_seq_sharded_f32_logits_match_jax(runs):
    check_logits(*runs, "float32", 1e-4)


def test_seq_sharded_bf16_logits_within_jax_bound(runs):
    check_logits(*runs, "bfloat16", 3e-2)


def test_seq_sharded_greedy_equals_unsharded(runs):
    check_greedy(runs[1])


def test_seq_sharded_caches(runs):
    check_caches(*runs)


def prefilled(cfg, B, plen, max_len, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = T.init_params(cfg, g, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, plen), generator=g)
    logits, filled = T.forward(cfg, params, toks, fill_cache=True)
    cache = install_prefill(cfg, T.init_cache(cfg, B, max_len, "cpu"), filled, plen)
    return params, cache, logits[:, -1:].argmax(-1).to(torch.int32)


def same_cache(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.is_floating_point():
            assert float((x - y).abs().max()) <= 1e-5
        else:
            assert torch.equal(x, y)


def test_windowed_ring_seq_sharded_equals_unsharded():
    cfg = dataclasses.replace(tget("h2o-danube-3-4b"), dtype="float32")
    assert cfg.window == 32 and cfg.n_kv_heads % 4
    params, cache, tok = prefilled(cfg, 4, 40, 64)
    assert cache["segments"][0]["k"].shape[3] == 32  # the ring, wrapped by the prompt
    ctx = mesh_ctx(cfg, False)
    sp, sc = place_params(cfg, tree_map(lambda x: x, params), ctx), place_cache(cfg, cache, ctx)
    assert tuple(sc["segments"][0]["k"].spec) == (None, "data", None, "model", None)
    t_local = t_shard = tok
    for _ in range(8):
        want, cache = T.decode_step(cfg, params, cache, t_local)
        got, sc = T.decode_step(cfg, sp, sc, t_shard, ctx=ctx)
        assert float((want - got).abs().max()) <= 1e-5 * float(want.abs().max())
        t_local, t_shard = want.argmax(-1).to(torch.int32), got.argmax(-1).to(torch.int32)
        assert torch.equal(t_local, t_shard)
    same_cache(cache, unshard(sc))


def test_inactive_slots_stay_bitwise():
    cfg = dataclasses.replace(tget("internlm2-1.8b"), dtype="float32", n_heads=4, n_kv_heads=2)
    params, cache, tok = prefilled(cfg, 4, 12, 32)
    # slot 3 is empty: no valid lane anywhere (pos 0, every slot_pos -1)
    for seg in cache["segments"]:
        seg["slot_pos"][:, 3] = -1
        seg["k"][:, 3] = 0
        seg["v"][:, 3] = 0
    cache["pos"][3] = 0
    active = torch.tensor([True, False, True, False])
    ctx = mesh_ctx(cfg, False)
    sp, sc = place_params(cfg, tree_map(lambda x: x, params), ctx), place_cache(cfg, cache, ctx)
    before = unshard(sc)
    for _ in range(3):
        want, cache = T.decode_step(cfg, params, cache, tok, active=active)
        got, sc = T.decode_step(cfg, sp, sc, tok, ctx=ctx, active=active)
        # every row's logits agree, the empty slot's uniform mean included
        assert float((want - got).abs().max()) <= 1e-5 * float(want.abs().max())
        tok = want.argmax(-1).to(torch.int32)
    after = unshard(sc)
    same_cache(cache, after)
    for x, y in zip(tree_leaves(before), tree_leaves(after)):
        ax = 1 if x.dim() > 1 else 0  # stacked segments: (L, B, ...); pos: (B,)
        for slot in (1, 3):
            assert torch.equal(x.select(ax, slot), y.select(ax, slot))
    assert torch.equal(after["pos"], torch.tensor([15, 12, 15, 0], dtype=torch.int32))

"""Dense decode through the paged kernels: on the card, the port's dense
decode runs K5 / K6 over the dense cache seen as one page a slot
(``dense_gqa_view`` / ``dense_mla_view``) and masks by lane, where the
CPU path runs ``attend`` / ``attend_mla`` masked by ``slot_pos``.

Here, on the CPU:
  * the views (identity page tables, the GQA view's page and head
    strides) through the kernels' plain versions equal ``attend`` /
    ``attend_mla`` on the same values, bit for bit, in f32 and bf16;
  * on every tick of a reduced dense internlm2 run (none / DMR / TMR,
    with slot reuse), every active slot's ``slot_pos`` mask equals the
    lane mask the kernels apply, so the card's dense path attends to the
    CPU path's lanes;
  * a windowed arch's ring reaches the kernels at the lane bound
    ``min(pos, S-1)``.
The ``cuda``-marked tests launch the kernels on such views.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_reduced
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import layers as L
from repro_torch.models.lm_cells import ServeConfig
from repro_torch.serving import Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def lane_mask(pos, S):
    return torch.arange(S)[None, :] <= pos[:, None]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(3, 4, 2, 24, 16), (2, 12, 1, 40, 8), (4, 8, 8, 16, 32)],
                         ids=["gqa", "mqa_group12", "mha"])
def test_gqa_dense_view_through_plain_equals_attend_bitwise(dtype, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(B * S + D)
    dt = DTYPES[dtype]
    q, k, v = rand(rng, B, Hq, D, dtype=dt), rand(rng, B, Hkv, S, D, dtype=dt), rand(rng, B, Hkv, S, D, dtype=dt)
    pos = torch.tensor(rng.integers(0, S, size=B), dtype=torch.int32)
    kv, vv, pages = pd.dense_gqa_view(k, v)
    assert kv.data_ptr() == k.data_ptr() and vv.data_ptr() == v.data_ptr()  # read in place
    assert kv.stride() == (S * D, S * D, D, 1) and pages[:, 0].tolist() == [b * Hkv for b in range(B)]
    got = pd.paged_gqa_attention(q, kv, vv, pages, pos)
    want = pd.attend(q, k, v, lane_mask(pos, S), D**-0.5)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,h,S,lora,rope", [(3, 4, 24, 16, 8), (2, 6, 40, 32, 16)],
                         ids=["small", "wider"])
def test_mla_dense_view_through_plain_equals_attend_mla_bitwise(dtype, B, h, S, lora, rope):
    rng = np.random.default_rng(B * S + lora)
    dt = DTYPES[dtype]
    q_lat, q_rope = rand(rng, B, h, lora, dtype=dt), rand(rng, B, h, rope, dtype=dt)
    ckv, krope = rand(rng, B, S, lora, dtype=dt), rand(rng, B, S, rope, dtype=dt)
    pos = torch.tensor(rng.integers(0, S, size=B), dtype=torch.int32)
    cv, rv, pages = pd.dense_mla_view(ckv, krope)
    assert cv.data_ptr() == ckv.data_ptr() and pages[:, 0].tolist() == list(range(B))
    scale = 0.125
    got = pd.paged_mla_attention(q_lat, q_rope, cv, rv, pages, pos, scale=scale)
    want = pd.attend_mla(q_lat, q_rope, ckv, krope, lane_mask(pos, S), scale)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_dense_gqa_view_of_a_layer_of_the_stacked_cache():
    """The engine hands each layer a view into the stacked cache (a
    storage offset): the view starts at the layer, not at the storage."""
    rng = np.random.default_rng(5)
    stacked = rand(rng, 3, 2, 2, 16, 8)
    kv, _, _ = pd.dense_gqa_view(stacked[1], stacked[1])
    assert kv.data_ptr() == stacked[1].data_ptr()
    assert torch.equal(pd.paged_gather(kv, torch.tensor([[0], [2]], dtype=torch.int32)), stacked[1])


def test_dense_gqa_view_refuses_a_non_contiguous_cache():
    k = torch.zeros(2, 2, 16, 8).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        pd.dense_gqa_view(k, k)


# ---------------------------------------------------------------------------
# the masks agree on every active slot of a served dense run
# ---------------------------------------------------------------------------
CFG = dc.replace(get_reduced("internlm2-1.8b"), dtype="float32")


def test_slot_pos_mask_equals_lane_mask_on_every_tick(monkeypatch):
    """A reduced dense internlm2 run, none / DMR / TMR, more replica slots
    asked of the batch than it holds (slots are freed and reused): after
    every decode write, every active slot's ``slot_pos`` mask is the lane
    mask ``lane <= pos``."""
    original = L.gqa_attention
    checked = {"slots": 0, "calls": 0}

    def checking(p, x, cfg, *, positions, cache=None, active=None, pages=None, **kw):
        out, cout = original(p, x, cfg, positions=positions, cache=cache, active=active,
                             pages=pages, **kw)
        if cache is not None and pages is None:
            pos = positions[:, 0]
            sp = cout["slot_pos"]
            lanes = lane_mask(pos, sp.shape[1])
            slot_mask = (sp >= 0) & (sp <= pos[:, None])
            rows = active.nonzero()[:, 0] if active is not None else torch.arange(sp.shape[0])
            assert torch.equal(slot_mask[rows], lanes[rows]), (pos.tolist(), sp.tolist())
            checked["slots"] += len(rows)
            checked["calls"] += 1
        return out, cout

    monkeypatch.setattr(L, "gqa_attention", checking)
    eng = api.serve(*lm_engine_parts(CFG, ServeConfig(batch=4, max_len=32), device="cpu"),
                    device="cpu")
    eng.start(0)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=t, policy=api.RedundancyPolicy(level=lv), id=f"m{i}")
            for i, (n, t, lv) in enumerate([(5, 4, 1), (9, 6, 2), (3, 3, 3), (12, 5, 1),
                                             (7, 6, 2), (4, 4, 3)])]
    for r in reqs[:3]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[3:]:
        assert eng.submit(r)
    eng.pump()
    assert all(eng.result(r.id)["tokens"] for r in reqs)
    assert checked["calls"] > 0 and checked["slots"] > checked["calls"]


# ---------------------------------------------------------------------------
# windowed archs
# ---------------------------------------------------------------------------
def test_windowed_dense_decode_on_the_card_raises():
    """Nothing raises now: the route is decided from the device alone (the
    kernels on a card, plain torch on the CPU), and a windowed arch's
    ring reaches the kernels with the lane bound ``min(pos, S-1)``
    (``ring_lane_pos``; ``tests/test_torch_window.py`` proves it equals
    the ``slot_pos`` mask on every tick).  Through K5's plain version, a
    wrapped ring of shuffled positions equals ``attend`` under JAX's
    window mask bitwise."""
    assert L.dense_decode_on_card(torch.device("cpu")) is False
    assert L.dense_decode_on_card(torch.device("cuda", 0)) is True
    pos = torch.tensor([0, 7, 8, 30], dtype=torch.int32)
    assert L.ring_lane_pos(pos, 8).tolist() == [0, 7, 7, 7]
    rng = np.random.default_rng(9)
    B, Hq, Hkv, S, D, window = 4, 4, 2, 8, 16, 8
    q, k, v = rand(rng, B, Hq, D), rand(rng, B, Hkv, S, D), rand(rng, B, Hkv, S, D)
    lanes = torch.arange(S)[None, :]
    # the ring after the write of pos: lane s holds the latest p <= pos with p % S == s
    slot_pos = torch.where(lanes <= pos[:, None], pos[:, None] - (pos[:, None] - lanes) % S, -1)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & (slot_pos > pos[:, None] - window)
    got = pd.paged_gqa_attention(q, *pd.dense_gqa_view(k, v), L.ring_lane_pos(pos, S))
    assert torch.equal(got, pd.attend(q, k, v, valid, D**-0.5))


@pytest.mark.cuda
def test_windowed_dense_decode_raises_on_a_cuda_tensor():
    """Windowed dense decode on a CUDA tensor reaches K5 (one launch, no
    fallback) at the clamped lane bound and agrees with the ``slot_pos``
    route within K5's f32 limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    q = rand(rng, 2, 4, 1, 16).cuda()
    k, v = rand(rng, 2, 2, 8, 16).cuda(), rand(rng, 2, 2, 8, 16).cuda()
    slot_pos = torch.tensor([[8, 9, 2, 3, 4, 5, 6, 7], [0, 1, 2, 3, -1, -1, -1, -1]],
                            device="cuda", dtype=torch.int32)
    pos = torch.tensor([9, 3], device="cuda", dtype=torch.int32)
    pd.paged_gqa_attention.launches = 0
    got = L.decode_attention(q, k, v, slot_pos, pos, window=8)
    assert pd.paged_gqa_attention.launches == 1
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & (slot_pos > pos[:, None] - 8)
    want = pd.attend(q[:, :, 0].cpu(), k.cpu(), v.cpu(), valid.cpu(), 16**-0.5)
    torch.testing.assert_close(got[:, :, 0].cpu(), want, atol=1e-4, rtol=1e-4)
    pd.paged_gqa_attention.launches = 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_on_dense_views_equal_plain_on_the_card(dtype):
    """K5 and K6 over dense views against their plain versions on the same
    views (f32 1e-4; bf16 K5 2e-2, K6 1e-3: its output is f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    dt = DTYPES[dtype]
    q, k, v = (rand(rng, 3, 12, 64, dtype=dt).cuda(), rand(rng, 3, 1, 128, 64, dtype=dt).cuda(),
               rand(rng, 3, 1, 128, 64, dtype=dt).cuda())
    pos = torch.tensor([0, 77, 127], dtype=torch.int32, device="cuda")
    view = pd.dense_gqa_view(k, v)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(pd.paged_gqa_attention(q, *view, pos).float(),
                               pd.paged_gqa_plain(q, *view, pos).float(), atol=tol, rtol=tol)
    ql, qr = rand(rng, 3, 64, 512, dtype=dt).cuda(), rand(rng, 3, 64, 64, dtype=dt).cuda()
    ckv, kr = rand(rng, 3, 128, 512, dtype=dt).cuda(), rand(rng, 3, 128, 64, dtype=dt).cuda()
    mview = pd.dense_mla_view(ckv, kr)
    tol = 1e-4 if dt == torch.float32 else 1e-3
    torch.testing.assert_close(pd.paged_mla_attention(ql, qr, *mview, pos, scale=0.07),
                               pd.paged_mla_plain(ql, qr, *mview, pos, scale=0.07),
                               atol=tol, rtol=tol)
    pd.paged_gqa_attention.launches = pd.paged_mla_attention.launches = 0

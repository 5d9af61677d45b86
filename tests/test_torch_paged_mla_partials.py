"""K6's partials entry point (``kernels.paged_decode.paged_mla_partials``)
by its plain version, on the CPU: each row's flash-decoding partial
``(acc, m, l)`` of absorbed-MLA attention over the latent lanes it is
given.

``acc / l`` is ``paged_mla_plain``'s output where a row has a valid lane;
a row without one (negative ``pos``, a member holding none of a slot's
lanes) is the empty partial m = -inf, l = 0, acc = 0, never the
whole-slot kernel's uniform mean; at every valid row the partials equal
the JAX package's member math (the body of
``repro/distributed/decode.py::mla_decode``, written out with
``jax.numpy`` on the same numpy inputs).  Combined over the members of a
mesh, they are ``paged_mla_plain`` over the whole pool:
``distributed/decode.py::paged_mla_decode`` on every route ("lanes",
"pages", "head") over random page tables, slots whose pages span both
data members and positions on page boundaries; a slot's result has the
same bits wherever its pages lie (replica slots); and the dense
sequence-sharded MLA decode takes the partials on the card's route
(``dense_decode_on_card`` forced) with JAX's einsums' result.  On the
card (the ``cuda``-marked cases), the kernel against the plain version
in f32 and bf16, with pages shorter than its 64-lane tile, ``pos = -1``
rows and a dense view."""

import numpy as np
import pytest
import torch

from repro_torch.distributed import decode as DD
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import P, shard_leaf
from repro_torch.kernels import paged_decode as pd
from repro_torch.models.layers import paged_write_rows
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

SCALE = (16 + 8) ** -0.5


def pools(N=16, ps=8, lora=16, rope=8, B=4, h=4, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    ckv, krope = (torch.randn((N, ps, d), generator=g).to(dtype) for d in (lora, rope))
    q_lat, q_rope = (torch.randn((B, h, d), generator=g).to(dtype) for d in (lora, rope))
    return q_lat, q_rope, ckv, krope


#: slot 0's pages span both halves of the pool's rows (0-7, 8-15);
#: positions on page boundaries (the last lane of a page, the first of the
#: next), a slot whose first page is unmapped
PAGES = torch.tensor([[3, 12, 5, -1], [9, 10, -1, -1], [-1, 1, 2, 15], [14, -1, -1, -1]],
                     dtype=torch.int32)
POS = torch.tensor([16, 15, 31, 0], dtype=torch.int32)


def held(got, want, tol=1e-5):
    """(acc, m, l) against the plain version: the same empty rows, the
    rest within ``tol`` of the largest value (atol = rtol)."""
    for a, b in zip(got, want):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        if fin.any():
            scale = max(float(b[fin].abs().max()), 1.0)
            assert float((a[fin].float() - b[fin].float()).abs().max()) <= tol * scale


def test_partials_normalise_to_the_attention():
    q_lat, q_rope, ckv, krope = pools()
    acc, m, l = pd.paged_mla_partials(q_lat, q_rope, ckv, krope, PAGES, POS, scale=SCALE)
    want = pd.paged_mla_plain(q_lat, q_rope, ckv, krope, PAGES, POS, scale=SCALE)
    ok = pd.paged_valid(PAGES, POS, 8).any(dim=1)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert ok.all()
    torch.testing.assert_close(acc[ok] / l[ok][..., None], want[ok], atol=1e-6, rtol=1e-5)
    assert (l[ok] >= 1).all() and torch.isfinite(m[ok]).all()
    assert pd.paged_mla_partials.launches == 0  # CPU tensors take the plain version


def test_row_without_a_valid_lane_is_the_empty_partial():
    """Negative positions and a slot with mapped pages but no valid lane:
    (0, -inf, 0), where the whole-slot plain version takes the mean."""
    q_lat, q_rope, ckv, krope = pools()
    pos = torch.tensor([-1, -30, 5, 3], dtype=torch.int32)  # slot 2's page 0 is unmapped
    acc, m, l = pd.paged_mla_partials(q_lat, q_rope, ckv, krope, PAGES, pos, scale=SCALE)
    assert torch.isneginf(m[:3]).all() and (l[:3] == 0).all() and (acc[:3] == 0).all()
    assert torch.isfinite(m[3]).all() and (l[3] > 0).all()
    whole = pd.paged_mla_plain(q_lat, q_rope, ckv, krope, PAGES, pos, scale=SCALE)
    assert whole[2].abs().sum() > 0  # the uniform mean the partials do not take


def jax_member_math(q_lat, q_rope, ckv, krope, valid, scale):
    """The member body of the JAX package's ``mla_decode`` (its lines from
    the scores to ``l``) on a member's dense latent lanes: ckv (B, S,
    lora), krope (B, S, rope), valid (B, S); q (B, 1, h, d)."""
    import jax.numpy as jnp  # here, not at the top: the card's cases run without JAX

    NEG_INF = -1e30
    s = jnp.einsum("bshl,btl->bhst", q_lat.astype(jnp.float32), ckv.astype(jnp.float32))
    s += jnp.einsum("bshr,btr->bhst", q_rope.astype(jnp.float32), krope.astype(jnp.float32))
    s *= scale
    s = jnp.where(valid[:, None, None, :], s, NEG_INF)
    m = jnp.max(s, axis=-1)
    e = jnp.exp(s - m[..., None])
    l = jnp.sum(e, axis=-1)
    ctx_l = jnp.einsum("bhst,btl->bshl", e, ckv.astype(jnp.float32))
    return ctx_l[:, 0], m[..., 0], l[..., 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_partials_equal_the_jax_member_math(seed):
    import jax.numpy as jnp

    q_lat, q_rope, ckv, krope = pools(seed=seed)
    pos = POS if seed == 0 else torch.tensor([31, 7, 12, 20], dtype=torch.int32)
    got = pd.paged_mla_partials(q_lat, q_rope, ckv, krope, PAGES, pos, scale=SCALE)
    valid = pd.paged_valid(PAGES, pos, 8)
    dense = [pd.paged_gather_lanes(x, PAGES) for x in (ckv, krope)]
    want = jax_member_math(*(jnp.asarray(x.numpy()) for x in (q_lat[:, None], q_rope[:, None],
                                                              *dense, valid)), SCALE)
    ok = valid.any(dim=1).numpy()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-5, atol=1e-5)


def test_partials_refuse_other_devices():
    args = [x.to("meta") for x in pools()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_mla_partials(*args, PAGES.to("meta"), POS.to("meta"), scale=SCALE)


# --------------------------------------------------------------------------
# the members of a mesh, combined
# --------------------------------------------------------------------------
N, PS, B, PMAX = 16, 8, 4, 4
#: (mesh, pool spec (N, ps, d), route)
LAYOUTS = [((1, 2), P(None, "model", None), "lanes"),
           ((1, 4), P(None, "model", None), "lanes"),
           ((2, 2), P("data", "model", None), "pages"),
           ((2, 4), P("data", "model", None), "pages"),
           ((2, 1), P("data", None, None), "pages"),
           ((1, 3), P(None, None, None), "head")]
IDS = [f"{s[0]}x{s[1]}" for s, _, _ in LAYOUTS]


def decode_on(layout, q_lat, q_rope, ckv, krope, pages, pos):
    shape, spec, route = layout
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    cache = {"ckv": shard_leaf(ckv, spec, mesh), "krope": shard_leaf(krope, spec, mesh)}
    idle = torch.zeros((B,), dtype=torch.bool)
    plan = DD.paged_plan(cache["ckv"], pages, pos, paged_write_rows(pages, pos, idle, N, PS),
                         latent=True)
    assert plan.route == route
    new = torch.zeros((B, ckv.shape[-1])), torch.zeros((B, krope.shape[-1]))
    return DD.paged_mla_decode(q_lat, q_rope, *new, cache, plan, scale=SCALE)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_member_partials_combined_equal_the_plain_version(layout, seed):
    q_lat, q_rope, ckv, krope = pools(seed=seed)
    pages, pos = PAGES.clone(), POS.clone()
    if seed:  # random tables: every slot's pages drawn from the whole pool
        g = torch.Generator().manual_seed(100 + seed)
        rows = torch.randperm(N, generator=g).to(torch.int32)
        pages = rows[:B * PMAX].reshape(B, PMAX)
        n = torch.randint(1, PMAX + 1, (B,), generator=g)
        pages = torch.where(torch.arange(PMAX)[None] < n[:, None], pages, -1)
        pos = ((n - 1) * PS + torch.randint(0, PS, (B,), generator=g)).to(torch.int32)
    got = decode_on(layout, q_lat, q_rope, ckv, krope, pages, pos)
    want = pd.paged_mla_plain(q_lat, q_rope, ckv, krope, pages, pos, scale=SCALE)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS[:5], ids=IDS[:5])
def test_a_slot_gets_equal_bits_wherever_its_pages_lie(layout):
    """Replica slots hold one request's pages at different pool rows: a
    slot's output must not depend on the members holding them."""
    q_lat, q_rope, ckv, krope = pools(seed=3)
    q_lat[1], q_rope[1] = q_lat[0], q_rope[0]
    ckv[[8, 9, 14]], krope[[8, 9, 14]] = ckv[[0, 1, 2]], krope[[0, 1, 2]]
    pages = torch.tensor([[0, 1, 2, -1], [8, 9, 14, -1], [3, -1, -1, -1], [4, -1, -1, -1]],
                         dtype=torch.int32)
    pos = torch.tensor([20, 20, 3, 5], dtype=torch.int32)
    out = decode_on(layout, q_lat, q_rope, ckv, krope, pages, pos)
    assert torch.equal(out[0], out[1])


def test_paged_mla_decode_writes_the_members_lanes():
    """The step's new lane lands on the member holding its row and lane,
    in every copy of a replicated block: the gathered pools equal the
    unsharded write."""
    q_lat, q_rope, ckv, krope = pools(seed=4)
    shape, spec, _ = LAYOUTS[3]
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)
    cache = {"ckv": shard_leaf(ckv.clone(), spec, mesh),
             "krope": shard_leaf(krope.clone(), spec, mesh)}
    act = torch.tensor([True, True, False, True])
    rows_lanes = paged_write_rows(PAGES, POS, act, N, PS)
    plan = DD.paged_plan(cache["ckv"], PAGES, POS, rows_lanes, latent=True)
    g = torch.Generator().manual_seed(5)
    new = torch.randn((B, 16), generator=g), torch.randn((B, 8), generator=g)
    DD.paged_mla_decode(q_lat, q_rope, *new, cache, plan, scale=SCALE)
    rows, lanes, sel = rows_lanes
    ckv[rows, lanes], krope[rows, lanes] = new[0][sel], new[1][sel]
    assert torch.equal(cache["ckv"].full(), ckv) and torch.equal(cache["krope"].full(), krope)


def test_dense_seq_sharded_members_take_the_partials_route(monkeypatch):
    """``DD.mla_decode`` on the card's route (K6's partials over each
    member's lanes read in place, bound ``ring_lane_pos(pos, S) - lo``),
    here through the plain version, gives the einsums' (JAX's) result."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models.lm_cells import place_cache
    from repro_torch.models import transformer as T

    cfg = get_reduced("deepseek-v3-671b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)
    S, lora, rope = 32, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
    g = torch.Generator().manual_seed(6)
    pos = torch.tensor([0, 7, 8, 31, 12, 5, 30, 16], dtype=torch.int32)
    one = T.init_cache(cfg, 8, S, "cpu")["segments"][0]
    layer = {k: v[0] for k, v in one.items()}
    lane = torch.arange(S)
    layer["ckv"], layer["krope"] = (torch.randn((8, S, d), generator=g) for d in (lora, rope))
    layer["slot_pos"] = torch.where(lane[None] < pos[:, None], lane[None], -1).to(torch.int32)
    q_lat, q_rope = (torch.randn((8, 1, 4, d), generator=g) for d in (lora, rope))
    ckv_new, krope_new = torch.randn((8, lora), generator=g), torch.randn((8, rope), generator=g)
    active = torch.tensor([True] * 7 + [False])
    outs = {}
    for route in ("einsums", "partials"):
        monkeypatch.setattr(DD, "dense_decode_on_card", lambda dev, r=route: r == "partials")
        cache = place_cache(cfg, {"segments": [{k: v.clone() for k, v in layer.items()}],
                                  "pos": pos.clone()}, ctx)["segments"][0]
        outs[route], _ = DD.mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, pos, cfg=cfg,
                                       ctx=ctx, active=active)
    # the active slots (an inactive one's lane at pos holds no write, and
    # no caller reads its row)
    torch.testing.assert_close(outs["partials"][:7], outs["einsums"][:7], atol=1e-6, rtol=1e-5)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 16, 64])
def test_partials_kernel_matches_plain_on_the_card(dtype, ps):
    """DeepSeek's latent widths (h 128, lora 512, rope 64) through a
    shuffled table of pages of 4 (shorter than the 64-lane tile), 16 and
    64 lanes, rows with pos -1, past the end and on a page boundary, and a
    dense view: within 1e-3 of the largest value, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K6's partials)")
    g = torch.Generator().manual_seed(7)
    Bc, h, lora, rope, S = 8, 128, 512, 64, 256
    Pc = S // ps
    q_lat, q_rope = (torch.randn((Bc, h, d), generator=g).to(dtype).cuda() for d in (lora, rope))
    ckv, krope = (torch.randn((Bc * Pc, ps, d), generator=g).to(dtype).cuda()
                  for d in (lora, rope))
    pages = torch.randperm(Bc * Pc, generator=g).reshape(Bc, Pc).to(torch.int32)
    pages[3, Pc // 2:] = -1
    pos = torch.tensor([-1, 0, ps - 1, ps, S // 2, S - 1, S + 100, -7], dtype=torch.int32)
    args = (q_lat, q_rope, ckv, krope, pages.cuda(), pos.cuda())
    dense = (q_lat, q_rope, *pd.dense_mla_view(*(torch.randn((Bc, S, d), generator=g)
                                                    .to(dtype).cuda() for d in (lora, rope))),
             pos.cuda())
    scale = (128 + 64) ** -0.5  # DeepSeek's (qk_nope + qk_rope) ** -0.5
    for a in (args, dense):
        before = pd.paged_mla_partials.launches
        got = pd.paged_mla_partials(*a, scale=scale)
        assert pd.paged_mla_partials.launches == before + 1
        held(got, pd.paged_mla_partials_plain(*a, scale=scale), tol=1e-3)
        assert torch.isneginf(got[1][0]).all() and (got[2][0] == 0).all()

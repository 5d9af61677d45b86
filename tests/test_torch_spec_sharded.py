"""Speculation under a ``ShardCtx``: the verify walk of
``make_slot_serve_program`` on a (2, 4) data x model mesh of CPU
devices, reduced f32 internlm2 as the target, with true
self-speculation and with a ``draft_arch`` draft (its own params laid
out by ``param_pspecs``, its dense cache by ``cache_pspecs``), each over
the dense cache and over paged pools.

On the stream of ``test_torch_serving_sharded_paged.SCENARIO`` (a strike
on a DMR replica slot), every request's tokens must be bitwise the plain
stream's on the same mesh, and verify walks, the tokens they commit and
the smallest commit must equal the unsharded speculating engine's.  The
JAX package's speculating engines on the same mesh are the other half
(``test_torch_spec_sharded_jax.py``, paged; ``..._dense_jax.py``).

Also: the members' partials of the paged routes, combined, against
``paged_gqa_plain`` over random page tables (a slot whose pages span
both data members, positions on page boundaries), equal bits for one
slot's pages wherever they lie, and what stays refused under a mesh:
spatial placement under ``make_ctx``'s ctx."""

import pytest
import torch

from repro_torch.distributed import decode as DD
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import LOCAL, P, shard_leaf
from repro_torch.kernels.paged_decode import paged_gqa_plain
from repro_torch.models.layers import paged_write_rows
from repro_torch.models.lm_cells import ServeConfig, SpecConfig, make_slot_serve_program
from repro_torch.testing import cap_threads_for_xdist
from test_torch_serving_sharded_paged import CFG, mesh_ctx, run

cap_threads_for_xdist()

MESH = (2, 4)
K = 3
DENSE = dict(batch=8, max_len=64)
PAGED = dict(batch=8, max_len=64, paged=True, page_size=8, page_budget=16)
#: case -> (ServeConfig keywords, the engine's SpecConfig keywords)
CASES = {"self-dense": (DENSE, {}), "self-paged": (PAGED, {}),
         "draft-dense": (DENSE, {"draft_arch": "internlm2-1.8b"}),
         "draft-paged": (PAGED, {"draft_arch": "internlm2-1.8b"})}
STRIKE = "r4"

def spec_kw(case):
    serve, spec = CASES[case]
    return dict(**serve, spec=SpecConfig(draft_len=K, **spec))


@pytest.fixture(scope="module")
def runs():
    """Each case on the mesh and unsharded, and the plain streams on the
    mesh, all from the port's seed."""
    out = {"sharded": {}, "local": {}, "plain": {}}
    ctx = mesh_ctx(MESH)
    req = SpecConfig(draft_len=K)
    for case in CASES:
        out["sharded"][case] = run(ctx, STRIKE, req_spec=req, **spec_kw(case))
        out["local"][case] = run(LOCAL, STRIKE, req_spec=req, **spec_kw(case))
    for kind, serve in (("dense", DENSE), ("paged", PAGED)):
        out["plain"][kind] = run(ctx, STRIKE, **serve)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_speculation_emits_the_plain_stream(runs, case):
    kind = "paged" if CASES[case][0].get("paged") else "dense"
    got = runs["sharded"][case]
    assert got["tokens"] == runs["plain"][kind]["tokens"]
    assert all(s == "done" for s in got["status"]) and got["request_faults"] == {STRIKE: 1}
    assert got["spec"]["spec_ticks"] > 0


@pytest.mark.parametrize("field", ["tokens", "status", "faults", "totals", "recent", "pages",
                                   "spec"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_speculation_equals_unsharded(runs, case, field):
    """Tokens, the ledger, the page tables, and the verify walks, the
    tokens they commit and the smallest commit: the unsharded
    speculating engine's."""
    assert runs["sharded"][case][field] == runs["local"][case][field]


# --------------------------------------------------------------------------
# the paged routes' member tables, against the plain version
# --------------------------------------------------------------------------
N, HKV, PS, D, B, PMAX = 16, 2, 8, 16, 4, 4
#: (mesh, pool spec (N, Hkv, ps, D), route)
LAYOUTS = [((1, 2), P(None, "model", None, None), "head"),
           ((2, 2), P("data", "model", None, None), "pages"),
           ((1, 4), P(None, None, "model", None), "lanes"),
           ((2, 4), P("data", None, "model", None), "pages")]


def pools(seed):
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn((N, HKV, PS, D), generator=g) for _ in range(2))
    q = torch.randn((B, 4, D), generator=g)
    return q, k, v


def decode_on(layout, q, k, v, pages, pos):
    shape, spec, route = layout
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    cache = {"k": shard_leaf(k, spec, mesh), "v": shard_leaf(v, spec, mesh)}
    idle = torch.zeros((B,), dtype=torch.bool)
    plan = DD.paged_plan(cache["k"], pages, pos, paged_write_rows(pages, pos, idle, N, PS))
    assert plan.route == route
    k_new = torch.zeros((B, HKV, D))
    return DD.paged_gqa_decode(q, k_new, k_new, cache, plan)


#: slot 0's pages span both data members' rows (0-7, 8-15); positions
#: on page boundaries (the last lane of a page, the first of the next)
PAGES = torch.tensor([[3, 12, 5, -1], [9, 10, -1, -1], [0, 1, 2, 15], [14, -1, -1, -1]],
                     dtype=torch.int32)
POS = torch.tensor([16, 15, 31, 0], dtype=torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{s[0]}x{s[1]}" for s, _, _ in LAYOUTS])
def test_member_partials_combined_equal_the_plain_version(layout, seed):
    q, k, v = pools(seed)
    g = torch.Generator().manual_seed(100 + seed)
    pages, pos = PAGES.clone(), POS.clone()
    if seed:  # random tables: every slot's pages drawn from the whole pool
        rows = torch.randperm(N, generator=g).to(torch.int32)
        pages = rows[:B * PMAX].reshape(B, PMAX)
        n = torch.randint(1, PMAX + 1, (B,), generator=g)
        pages = torch.where(torch.arange(PMAX)[None] < n[:, None], pages, -1)
        pos = ((n - 1) * PS + torch.randint(0, PS, (B,), generator=g)).to(torch.int32)
    got = decode_on(layout, q, k, v, pages, pos)
    want = paged_gqa_plain(q, k, v, pages, pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids=["2x2", "1x4", "2x4"])
def test_a_slot_gets_equal_bits_wherever_its_pages_lie(layout):
    """Replica slots hold one request's pages at different pool rows: a
    slot's output must not depend on the members holding them."""
    q, k, v = pools(3)
    q[1] = q[0]
    k[[8, 9, 14]], v[[8, 9, 14]] = k[[0, 1, 2]], v[[0, 1, 2]]
    pages = torch.tensor([[0, 1, 2, -1], [8, 9, 14, -1], [3, -1, -1, -1], [4, -1, -1, -1]],
                         dtype=torch.int32)
    pos = torch.tensor([20, 20, 3, 5], dtype=torch.int32)
    out = decode_on(layout, q, k, v, pages, pos)
    assert torch.equal(out[0], out[1])


# --------------------------------------------------------------------------
# what stays refused under a mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
def test_spatial_placement_under_a_mesh_raises(paged):
    with pytest.raises(NotImplementedError, match="spatial"):
        make_slot_serve_program(CFG, ServeConfig(batch=8, max_len=64, paged=paged, page_size=8,
                                                 placement="spatial"), mesh_ctx(MESH))

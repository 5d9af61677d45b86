"""Speculative decoding on replica slots: the port's engine against the
JAX package's (tests/test_spec.py's gates, on the same inputs).

tiny_lm (reduced internlm2-1.8b: d_model 32, 2 layers, vocab 128) in
f32; the JAX engine's weights and initial states are carried over to the
port through ``repro_torch.bridge``.  Tokens, FaultLedger entries, the
spec counters and page faults are held EQUAL to the JAX engine's, and the
tokens also to JAX plain greedy decode.  The JAX engines are shared
through module fixtures (each compiles once).
"""

import dataclasses as dc
import itertools

import jax
import numpy as np
import pytest

from repro import api as jmiso
from repro.configs import get_reduced
from repro.models import lm_cells as jlc
from repro.serving import DONE
from repro.serving import Request as JRequest
from repro.serving.lm import lm_engine_parts as jax_parts
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import get_reduced as tget
from repro_torch.models import lm_cells as tlc
from repro_torch.serving import REJECTED
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.serving.paging import host_k_eff
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

TINY = dict(d_model=32, n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1, vocab_size=128,
            dtype="float32")
CFG = dc.replace(get_reduced("internlm2-1.8b"), **TINY)
TCFG = dc.replace(tget("internlm2-1.8b"), **TINY)
LEVELS = [1, 2, 3, 1, 2]
PROMPTS = [
    np.random.default_rng(i).integers(0, CFG.vocab_size, size=n).astype(np.int32)
    for i, n in enumerate([5, 9, 3, 12, 7])
]
BUDGET = 11
K = 3
_ids = itertools.count()
_bases = itertools.count(1)


def scfg_kw(**over):
    return dict(batch=4, max_len=32, **over)


def spec_kw(paged=False, page_size=8, **spec):
    kw = dict(paged=paged, page_size=page_size) if paged else {}
    return scfg_kw(**kw, spec=("spec", dict(draft_len=K, **spec)))


def build(kw, which):
    """ServeConfig of the JAX package ("jax") or the port ("torch")."""
    lc = jlc if which == "jax" else tlc
    kw = dict(kw)
    if kw.get("spec") is not None:
        kw["spec"] = lc.SpecConfig(**kw["spec"][1])
    return lc.ServeConfig(**kw)


class Pair:
    """A JAX engine and port engines started from its initial states."""

    def __init__(self, kw):
        self.kw = kw
        self.jeng = jmiso.serve(*jax_parts(CFG, build(kw, "jax")))
        self.jeng.start(jax.random.PRNGKey(0))
        self.init = jax.tree.map(np.asarray, self.jeng._states)
        self.teng = self.port()

    def port(self, kw=None, tracer=None):
        """A port engine with the JAX engine's states; with another
        config ``kw``, its weights and the port's own empty slots."""
        parts = torch_parts(TCFG, build(kw or self.kw, "torch"), device="cpu")
        eng = tmiso.serve(*parts, tmiso.EngineConfig(tracer=tracer), device="cpu")
        states = bridge.states_from_numpy(self.init, device="cpu")
        if kw is not None:
            states = {**eng.exe.init(0), "weights": states["weights"]}
        eng.start(states=states)
        return eng


def req(R, Pol, prompt, n=BUDGET, level=1, spec=K, **kw):
    sc = None
    if spec:
        sc = (jlc if R is JRequest else tlc).SpecConfig(draft_len=spec)
    return R(prompt=prompt, max_new_tokens=n, policy=Pol(level=level), spec=sc,
             id=f"q{next(_ids)}", **kw)


def both(pair, fn):
    """``fn(engine, Request, RedundancyPolicy, FaultSpec)`` on both
    engines, whose requests get the same ids (ledgers are keyed by id)."""
    global _ids
    base = 1000 * next(_bases)
    out = []
    for args in ((pair.jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec),
                 (pair.teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)):
        _ids = itertools.count(base)
        out.append(fn(*args))
    return tuple(out)


def staggered(eng, R, Pol, _F):
    """Half the requests now, the rest after two ticks (more replica
    slots than the batch holds, so requests queue too)."""
    reqs = [req(R, Pol, p, level=lv) for p, lv in zip(PROMPTS, LEVELS)]
    for r in reqs[:2]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[2:]:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


def strike(level, key="tokens"):
    """A bit flip into the first leaf under ``key`` (``tokens``, or
    ``draft_cache``'s ``pos``) of the victim's last replica slot."""
    def run(eng, R, Pol, F):
        victim = req(R, Pol, PROMPTS[1], n=10, level=level)
        assert eng.submit(victim)
        eng.pump(max_ticks=1)  # admitted; the next ticks verify
        dec = eng._states["decoder"]
        leaf = (tree.leaf_index(dec, key) if R is TRequest else jax_leaf_index(dec, key))
        fault = F.at(step=eng.exe.metrics()["steps"] + 1,
                     cell_id=eng.exe.program.cell_id("decoder"), leaf=leaf,
                     index=eng.requests[victim.id].slots[-1], bit=2)
        eng.pump(faults=fault)  # the strike lands mid-verify
        return eng.result(victim.id), eng.ledger.totals[victim.id]

    return run


def jax_leaf_index(state, key):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return next(i for i, (path, _) in enumerate(flat)
                if any(getattr(p, "key", None) == key for p in path))


def short_budgets(eng, R, Pol, _F):
    """draft_len 3 against budgets 1-4: the clamp to the remaining budget."""
    reqs = [req(R, Pol, PROMPTS[2], n=n) for n in (1, 2, 3, 4)]
    for r in reqs:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


def spec_metrics(eng):
    m = eng.metrics()
    return {k: m[k] for k in ("spec_ticks", "spec_tokens", "spec_min_commit",
                              "spec_tokens_per_tick", "spec_draft_len", "spec_draft_arch")}


@pytest.fixture(scope="module")
def greedy():
    """JAX plain greedy decode of every prompt, budget BUDGET (shorter
    budgets are prefixes)."""
    eng = jmiso.serve(*jax_parts(CFG, build(scfg_kw(), "jax")))
    eng.start(jax.random.PRNGKey(0))
    out = {}
    for p in PROMPTS:
        r = JRequest(prompt=p, max_new_tokens=BUDGET)
        assert eng.submit(r)
        eng.pump()
        out[tuple(p)] = eng.result(r.id)["tokens"]
    return out


@pytest.fixture(scope="module")
def runs():
    """Every scenario on shared engines, in order: the stream, the budget
    clamp and the two strikes (dense, paged); the stream, the strikes and
    a walk beside a verifier on the divergent draft, whose engine also
    chunks its prefills (``prefill_chunk=3``)."""
    out = {}
    for paged in (False, True):
        pair = Pair(spec_kw(paged=paged))
        r = out[paged] = {"pair": pair}
        r["stream"] = both(pair, staggered)
        r["stream_metrics"] = (spec_metrics(pair.jeng), spec_metrics(pair.teng))
        r["budgets"] = both(pair, short_budgets)
        for level in (2, 3):
            r[f"strike{level}"] = both(pair, strike(level))
        r["ledger"] = (pair.jeng.ledger.totals, pair.teng.ledger.totals)
    pair = Pair({**spec_kw(paged=True, page_size=4, draft_param_seed=7), "prefill_chunk": 3,
                 "prefill_bucket_min": 2})
    r = out["divergent"] = {"stream": both(pair, staggered),
                            "metrics": (pair.jeng.metrics(), pair.teng.metrics())}
    # strikes on the draft's own cache: the nested leaves through the
    # paged surgery (DMR adopt and damage_vs, TMR copy and damage)
    for level in (2, 3):
        r[f"strike{level}"] = both(pair, strike(level, "draft_cache"))

    def walk(eng, R, Pol, _F):
        long_r = req(R, Pol, PROMPTS[3], n=6)
        short_r = req(R, Pol, PROMPTS[2], n=8, level=2)
        assert eng.submit(short_r)
        eng.pump(max_ticks=1)
        assert eng.submit(long_r)
        eng.pump()
        return [eng.result(x.id) for x in (long_r, short_r)]

    before = spec_metrics(pair.teng)
    out["walk"] = {"runs": both(pair, walk), "before": before,
                   "metrics": (spec_metrics(pair.jeng), spec_metrics(pair.teng))}
    return out


def tokens(results):
    return [r["tokens"] for r in results]


# ---------------------------------------------------------------------------
# (1) the staggered none/DMR/TMR stream, dense and paged
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_stream_tokens_equal_jax_and_greedy(runs, greedy, paged):
    jres, tres = runs[paged]["stream"]
    assert tokens(tres) == tokens(jres)
    assert tokens(tres) == [greedy[tuple(p)] for p in PROMPTS]
    assert all(r["status"] == DONE and r["faults"] == 0 for r in tres)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_stream_spec_counters_equal_jax(runs, paged):
    jm, tm = runs[paged]["stream_metrics"]
    assert tm == jm
    assert tm["spec_tokens_per_tick"] > 1 and tm["spec_draft_arch"] == "self"


# ---------------------------------------------------------------------------
# (2) a divergent draft: real rejections and rollbacks, pages of 4
# ---------------------------------------------------------------------------
def test_divergent_draft_tokens_and_page_faults_equal_jax(runs, greedy):
    jres, tres = runs["divergent"]["stream"]
    assert tokens(tres) == tokens(jres) == [greedy[tuple(p)] for p in PROMPTS]
    jm, tm = runs["divergent"]["metrics"]
    for k in ("spec_ticks", "spec_tokens", "spec_min_commit", "page_faults", "pages_free"):
        assert tm[k] == jm[k], k
    assert tm["spec_min_commit"] == 1 and tm["spec_tokens_per_tick"] < K + 1
    assert tm["page_faults"] > 0 and tm["pages_free"] == tm["pages_total"]


# ---------------------------------------------------------------------------
# (3) a strike mid-verify, DMR and TMR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True, "divergent"],
                         ids=["dense", "paged", "paged-draft-cache"])
@pytest.mark.parametrize("level", [2, 3], ids=["dmr", "tmr"])
def test_strike_mid_verify_ledger_equals_jax(runs, greedy, paged, level):
    (jv, jled), (tv, tled) = runs[paged][f"strike{level}"]
    assert tv["faults"] == jv["faults"] == 1 and tv["status"] == DONE
    assert tled == jled  # events, damaged elements, struck replica
    assert tv["tokens"] == jv["tokens"] == greedy[tuple(PROMPTS[1])][:10]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_ledgers_equal_jax(runs, paged):
    jled, tled = runs[paged]["ledger"]
    assert tled == jled and len(tled) == 2


# ---------------------------------------------------------------------------
# (4) draft_len beyond the remaining budget; beside a chunked prefill walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_draft_len_beyond_budget_is_clamped(runs, greedy, paged):
    jres, tres = runs[paged]["budgets"]
    assert tokens(tres) == tokens(jres)
    ref = greedy[tuple(PROMPTS[2])]
    assert tokens(tres) == [ref[:n] for n in (1, 2, 3, 4)]
    assert [r["n_tokens"] for r in tres] == [1, 2, 3, 4]


def test_spec_beside_chunked_prefill_walk(runs, greedy):
    jres, tres = runs["walk"]["runs"]
    assert tokens(tres) == tokens(jres)
    assert tres[0]["tokens"] == greedy[tuple(PROMPTS[3])][:6]
    assert tres[1]["tokens"] == greedy[tuple(PROMPTS[2])][:8]
    jm, tm = runs["walk"]["metrics"]
    assert tm == jm and tm["spec_ticks"] > runs["walk"]["before"]["spec_ticks"]


# ---------------------------------------------------------------------------
# (5) the port alone
# ---------------------------------------------------------------------------
def test_spec_k_eff_equals_pre_tick_host_mirror():
    import torch

    max_len, grid = 32, []
    for spec_k, budget, n_dec, pos in itertools.product(range(5), range(1, 12), range(10),
                                                        range(26, 32)):
        grid.append((spec_k, budget, n_dec, pos))
    cols = [torch.tensor(c, dtype=torch.int32) for c in zip(*grid)]
    for draft_len in (1, 3, 4):
        dev = tlc.spec_k_eff(*cols, max_len, draft_len).tolist()
        host = [host_k_eff(*g, max_len, draft_len) for g in grid]
        assert dev == host
        jx = np.asarray(jlc.spec_k_eff(*[np.asarray(c) for c in cols], max_len, draft_len))
        assert dev == jx.tolist()


def test_refusals_match_jax():
    for lc in (jlc, tlc):
        with pytest.raises(ValueError, match="draft_len must be >= 1"):
            lc.SpecConfig(draft_len=0)
    # a draft whose vocab differs from the target's
    errs = []
    for lc, cfg in ((jlc, CFG), (tlc, TCFG)):
        with pytest.raises(ValueError) as e:
            lc.resolve_draft_config(cfg, lc.SpecConfig(draft_arch="internlm2-1.8b"))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "does not match target 128" in errs[1]
    # a draft that cannot roll back (recurrent)
    errs = []
    for lc, cfg, reduced in ((jlc, CFG, get_reduced), (tlc, TCFG, tget)):
        target = dc.replace(cfg, vocab_size=reduced("mamba2-2.7b").vocab_size)
        with pytest.raises(ValueError) as e:
            lc.resolve_draft_config(target, lc.SpecConfig(draft_arch="mamba2-2.7b"))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "cannot roll back" in errs[1]


def test_request_with_another_draft_arch_rejected(runs):
    eng = runs[False]["pair"].port()
    r = TRequest(prompt=PROMPTS[0], spec=tlc.SpecConfig(draft_arch="mamba2-2.7b"))
    assert not eng.submit(r)
    assert eng.result(r.id)["status"] == REJECTED
    assert eng.metrics()["rejected_invalid"] == 1


def test_spec_request_on_plain_engine_and_plain_request_on_spec_engine(runs, greedy):
    pair = runs[False]["pair"]
    plain = pair.port(scfg_kw())  # the same weights, no spec
    r = req(TRequest, tmiso.RedundancyPolicy, PROMPTS[4])
    assert plain.submit(r)
    plain.pump()
    assert plain.result(r.id)["tokens"] == greedy[tuple(PROMPTS[4])]
    assert "spec_ticks" not in plain.metrics()
    eng = pair.port()
    r = req(TRequest, tmiso.RedundancyPolicy, PROMPTS[4], spec=0)
    assert eng.submit(r)
    eng.pump()
    assert eng.result(r.id)["tokens"] == greedy[tuple(PROMPTS[4])]
    assert eng.metrics()["spec_ticks"] == 0


def test_mamba2_falls_back_to_plain_decode():
    cfg = dc.replace(tget("mamba2-2.7b"), n_layers=2, dtype="float32")
    out = {}
    for name, spec in (("plain", None), ("spec", tlc.SpecConfig(draft_len=K))):
        prog, adapter = torch_parts(cfg, tlc.ServeConfig(batch=2, max_len=32, spec=spec),
                                    device="cpu")
        eng = tmiso.serve(prog, adapter, device="cpu")
        eng.start(0)
        assert "spec_k" not in eng._states["decoder"] and adapter.read_spec is None
        r = TRequest(prompt=PROMPTS[0], max_new_tokens=6, spec=tlc.SpecConfig(draft_len=K))
        assert eng.submit(r)
        eng.pump()
        out[name] = (eng.result(r.id)["tokens"], eng.metrics())
    assert out["spec"][0] == out["plain"][0] and len(out["plain"][0]) == 6
    assert out["spec"][1]["spec_draft_len"] == 0 and "spec_ticks" not in out["spec"][1]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("draft", [False, True], ids=["self", "draft"])
def test_decoder_leaf_paths_equal_jax(paged, draft):
    """A FaultSpec names a leaf by its index: the spec leaves and the
    draft cache sit where JAX puts them."""
    dj = CFG if draft else None
    dt = TCFG if draft else None
    if paged:
        jst = jlc.paged_slot_decoder_init(CFG, 2, 32, 8, 4, dj, K)
        tst = tlc.paged_slot_decoder_init(TCFG, 2, 32, 8, 4, "meta", dt, K)
    else:
        jst = jlc.slot_decoder_init(CFG, 2, 32, dj, K)
        tst = tlc.slot_decoder_init(TCFG, 2, 32, "meta", dt, K)
    flat, _ = jax.tree_util.tree_flatten_with_path(jst)
    jpaths = [tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
              for path, _ in flat]
    assert tree.tree_paths(tst) == jpaths
    assert [tuple(x.shape) for x in tree.tree_leaves(tst)] == [x.shape for _, x in flat]
    assert ("draft_cache" in tst) == draft and tst["spec_out"].shape == (2, K + 1)

"""``examples/serve_walkthrough_torch.py --smoke`` on ``--device cpu``
against JAX's ``examples/serve_walkthrough.py --smoke``, run in-process
(``runpy``, its flags parsed at import).  Section 1's slotted program
is plain arithmetic, so its tokens are equal bitwise; sections 2 and 3
serve a model whose weights each package draws itself, so their integer
outcomes are compared: done counts, pages free and page faults after
the drain, and the speculating request's verify ticks and tokens."""

from repro_torch.testing import cap_threads_for_xdist
from test_torch_examples import example, run_jax

cap_threads_for_xdist()


def adapter(metrics, plain, guarded) -> dict:
    return {
        "counts": (metrics["done"], metrics["submitted"], metrics["tokens_out"]),
        "requests": [(str(r["status"]), list(r["slots"]), r["faults"],
                      [int(t) for t in r["tokens"]]) for r in (plain, guarded)],
    }


PAGED = ("done", "submitted", "pages_free", "pages_total", "page_size", "page_faults",
         "prefill_chunk")
SPEC = ("done", "spec_ticks", "spec_tokens", "spec_tokens_per_tick")


def test_serve_walkthrough_smoke(monkeypatch):
    g = run_jax("serve_walkthrough", monkeypatch, ["--smoke"])
    out = example("serve_walkthrough_torch").main(["--device", "cpu", "--smoke"])
    eng = g["engine"]
    assert adapter(out["adapter"]["metrics"], out["adapter"]["plain"],
                   out["adapter"]["guarded"]) == adapter(
        g["em"], eng.result(g["plain"].id), eng.result(g["guarded"].id))
    assert {k: out["paged"][k] for k in PAGED} == {k: g["pm"][k] for k in PAGED}
    assert out["paged"]["pages_free"] == out["paged"]["pages_total"]
    assert {k: out["spec"][k] for k in SPEC} == {k: g["sm"][k] for k in SPEC}
    assert len(out["spec_tokens"]) == len(g["spec_toks"])
    assert out["spec"]["spec_tokens_per_tick"] > 1

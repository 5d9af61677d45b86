"""``examples/serve_lm_torch.py --strike`` on ``--device cpu`` against
JAX's ``examples/serve_lm.py --strike``, run in-process (``runpy``, its
flags parsed at import).  The weights differ (each package draws its
own), so the integer outcomes are compared: the done and token counts,
and each request's status, slots, fault count and token count."""

from repro_torch.testing import cap_threads_for_xdist
from test_torch_examples import example, run_jax

cap_threads_for_xdist()


def outcome(metrics, requests) -> dict:
    return {
        "done": (metrics["done"], metrics["submitted"], metrics["tokens_out"]),
        "requests": {name: (str(r["status"]), list(r["slots"]), r["faults"], r["n_tokens"])
                     for name, r in requests.items()},
    }


def test_serve_lm_strike(monkeypatch):
    g = run_jax("serve_lm", monkeypatch, ["--strike"])
    eng = g["engine"]
    want = outcome(g["m"], {"A none": eng.result(g["a"].id), "B dmr": eng.result(g["b"].id),
                            "C tmr": eng.result(g["c"].id)})
    assert want["requests"]["B dmr"][2] >= 1  # JAX's strike hit B
    got = example("serve_lm_torch").main(["--device", "cpu", "--strike"])
    assert outcome(got["metrics"], got["requests"]) == want

"""The serving launcher's engine path speculating (``--spec-k 2
--strike``) against the JAX package's on reduced f32 internlm2, dense and
paged: the printed request and strike lines equal, every token stream
bitwise JAX's engine's, the same victim, and the verify counters equal.
The helpers are ``test_torch_launch_serve.py``'s."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_launch_serve import BASE, check_parity, run_both

cap_threads_for_xdist()

SPEC = [a if a != "6" else "12" for a in BASE] + ["--spec-k", "2"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_strike_equals_jax(monkeypatch, capsys, paged):
    argv = SPEC + (["--paged", "--page-size", "8"] if paged else [])
    jeng, teng, jax_out, port_out = run_both(argv, monkeypatch, capsys)
    check_parity(jeng, teng, jax_out, port_out)
    jm, tm = jeng.metrics(), teng.metrics()
    assert (tm["spec_ticks"], tm["spec_tokens"]) == (jm["spec_ticks"], jm["spec_tokens"])
    assert tm["spec_tokens"] > tm["spec_ticks"] > 0  # more than one token a verify walk
    spec_line = [ln for ln in port_out if ln.startswith("spec: k=2 draft=self")]
    assert spec_line == [ln for ln in jax_out if ln.startswith("spec: k=2 draft=self")]

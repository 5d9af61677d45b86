"""The serving launcher's engine path (``launch/serve.py``) against the
JAX package's on reduced f32 internlm2, dense and ``--paged``, each with
``--strike``: JAX's ``engine_main(cfg, args)`` and the port's on the same
config and arguments, the port started from JAX's init states
(``prog.init_states(PRNGKey(seed))``, carried across).  The printed
request lines (status, token count, faults, first 8 tokens) and the
strike line are equal; every token stream is bitwise JAX's engine's; the
victim is the same request.  Also: ``--trace-out`` / ``--metrics-json``
written and well formed, the multi-codebook refusal (where JAX's
launcher fails), ``--placement spatial`` on the one CPU device (1 pod:
bitwise JAX's temporal engine) and JAX's refusal of a pod count that
does not divide the devices, and the default device is the card.  ``test_torch_launch_serve_spec.py`` holds ``--spec-k``."""

import dataclasses as dc
import importlib.util
import itertools
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.serving.request as jreq
from repro.configs import get_reduced
from repro.distributed.sharding import LOCAL
from repro.launch import serve as JS
from repro.models.lm_cells import ServeConfig as JServeConfig
from repro.models.lm_cells import SpecConfig as JSpecConfig
from repro.serving.lm import lm_engine_parts as jax_parts
import repro_torch.serving.request as treq
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.launch import serve as TS
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("validate_trace", ROOT / "tools" / "validate_trace.py")
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

CFG = dc.replace(get_reduced("internlm2-1.8b"), dtype="float32")
TCFG = dc.replace(tget("internlm2-1.8b"), dtype="float32")
BASE = ["--device", "cpu", "--arch", "internlm2-1.8b", "--reduced", "--slots", "4",
        "--requests", "4", "--mix", "none,dmr", "--decode", "6", "--prompt-len", "4",
        "--max-len", "32", "--strike"]


def jax_states(args):
    """The states JAX's ``engine_main`` starts from: its program's
    ``init_states(PRNGKey(seed))``."""
    spec = JSpecConfig(draft_len=args.spec_k, draft_arch=args.spec_arch) if args.spec_k else None
    scfg = JServeConfig(batch=args.slots, max_len=args.max_len, prefill_chunk=args.prefill_chunk,
                        prefill_bucket_min=args.prefill_bucket_min, paged=args.paged,
                        page_size=args.page_size, spec=spec)
    prog, _ = jax_parts(CFG, scfg, LOCAL)
    return prog.init_states(jax.random.PRNGKey(args.seed))


def run_both(argv, monkeypatch, capsys, port_extra=()):
    """JAX's ``engine_main`` then the port's, on the same arguments (the
    port's with ``port_extra`` appended), the request counters of both
    packages restarted.  Returns the JAX engine, the port's, and each
    one's printed lines."""
    args = TS.parser().parse_args(argv)
    engines = []
    real_serve = japi.serve
    monkeypatch.setattr(japi, "serve", lambda *a, **k: engines.append(real_serve(*a, **k))
                        or engines[-1])
    monkeypatch.setattr(jreq, "_ids", itertools.count())
    JS.engine_main(CFG, args)
    jax_out = capsys.readouterr().out.splitlines()
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jax_states(args)), device="cpu")
    monkeypatch.setattr(treq, "_ids", itertools.count())
    teng = TS.engine_main(TCFG, TS.parser().parse_args(list(argv) + list(port_extra)),
                          states=states)
    port_out = capsys.readouterr().out.splitlines()
    return engines[0], teng, jax_out, port_out


def request_lines(out):
    return [ln for ln in out if ln.startswith("  r") or ln.startswith("strike:")]


def check_parity(jeng, teng, jax_out, port_out):
    assert request_lines(port_out) == request_lines(jax_out)
    assert any(ln.startswith("strike: detected, attributed to") for ln in port_out)
    assert list(teng.requests) == list(jeng.requests)
    for rid in jeng.requests:
        j, t = jeng.result(rid), teng.result(rid)
        assert t["tokens"] == [int(x) for x in j["tokens"]], rid
        assert (t["status"], t["faults"], t["slots"]) == (j["status"], j["faults"], j["slots"])
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["request_faults"] == jm["request_faults"] and len(tm["request_faults"]) == 1
    assert tm["ticks"] == jm["ticks"]


def test_dense_strike_equals_jax(monkeypatch, capsys):
    check_parity(*run_both(BASE, monkeypatch, capsys))


def test_paged_strike_trace_and_metrics_equal_jax(monkeypatch, capsys, tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    argv = BASE + ["--paged", "--page-size", "8", "--trace-out", str(trace),
                   "--metrics-json", str(metrics)]
    jeng, teng, jax_out, port_out = run_both(argv, monkeypatch, capsys)
    check_parity(jeng, teng, jax_out, port_out)
    assert teng.metrics()["paged"] and teng.metrics()["pages_free"] == teng.metrics()["pages_total"]
    # the port's files (JAX's wrote the same paths first, then the port's)
    assert validate_trace.validate_file(str(trace)) == []
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "strike_repaired" in names
    snap = json.loads(metrics.read_text())
    assert snap["serving_strikes_detected_total"]["value"] == 1.0
    assert snap["serving_requests_done_total"]["value"] == 4.0
    assert any(ln.startswith("trace: ") for ln in port_out)
    assert any(ln.startswith("metrics snapshot -> ") for ln in port_out)


def test_multi_codebook_engine_refused_where_jax_fails():
    """The reference launcher draws 1-D prompts, which a multi-codebook
    engine cannot reshape; the port's refuses before serving."""
    argv = ["--device", "cpu", "--arch", "musicgen-large", "--reduced", "--slots", "2",
            "--requests", "1", "--mix", "none", "--decode", "2", "--prompt-len", "4",
            "--max-len", "16"]
    args = TS.parser().parse_args(argv)
    with pytest.raises(ValueError, match="cannot reshape"):
        JS.engine_main(get_reduced("musicgen-large"), args)
    with pytest.raises(SystemExit, match="codebooks") as e:
        TS.main(argv)
    assert "--static" in str(e.value)


def test_spatial_one_pod_launcher_equals_jax_temporal(monkeypatch, capsys):
    """One CPU device gives one pod: the spatial engine serves every
    request bitwise as JAX's temporal engine does, the strike included."""
    jeng, teng, jax_out, port_out = run_both(BASE, monkeypatch, capsys,
                                             ["--placement", "spatial"])
    check_parity(jeng, teng, jax_out, port_out)
    m = teng.metrics()
    assert (m["placement"], m["pods"], m["backend"]) == ("spatial", 1, "spatial_lockstep")
    assert any(ln.startswith("placement: spatial (1 pods x 4 slots") for ln in port_out)


@pytest.mark.parametrize("extra", [["--placement", "spatial", "--pods", "2"],
                                   ["--placement", "spatial", "--pods", "3"]])
def test_spatial_placement_refused(extra):
    """A pod count that does not divide the devices present (one CPU) is
    refused as JAX's launcher refuses it, with the same message."""
    args = TS.parser().parse_args(BASE + extra)
    with pytest.raises(SystemExit) as je:
        JS.engine_main(CFG, args)
    with pytest.raises(SystemExit) as te:
        TS.main(BASE + extra)
    assert str(te.value) == str(je.value) and "does not divide 1 devices" in str(te.value)


@pytest.mark.parametrize("static", [False, True])
def test_default_device_is_the_card(static):
    assert TS.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would serve on it")
    argv = ["--arch", "internlm2-1.8b", "--reduced"] + (["--static"] if static else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(argv)

"""The port's loop examples (``examples/{quickstart,image_blend}_torch.py``)
on ``--device cpu``, each passing its own asserts.  JAX's
``quickstart.py`` and ``image_blend.py`` run in-process beside them
(``runpy``, their flags parsed at import): image_blend's ASCII frames
are equal character for character; quickstart's integer outcomes (the
resolved back-end, the unit lead, the detected step, ledger events,
recoveries, the verdicts) are equal and its floats within 1e-4.  The
two serving examples are held against JAX's in
``test_torch_examples_serve_lm.py`` and
``test_torch_examples_walkthrough.py``."""

import importlib.util
import pathlib
import runpy
import sys

import pytest

from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name: str, monkeypatch, argv=()) -> dict:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")


@pytest.fixture(scope="module")
def jax_quickstart():
    with pytest.MonkeyPatch.context() as mp:
        g = run_jax("quickstart", mp)
    dm = g["dmr"].metrics()
    return {
        "peak": float(g["final"]["probe"]["peak"]), "mean": float(g["final"]["probe"]["mean"]),
        "auto_backend": g["m"]["backend"], "auto_same": bool(g["same"]),
        "max_lead": int(g["m"]["max_lead"]),
        "dmr_events": float(dm["fault_totals"]["rod"]["events"]),
        "dmr_detected": [int(s) for s in g["dmr"].ledger.recent["rod"]],
        "dmr_recoveries": len(dm["recoveries"]), "dmr_repaired": bool(g["repaired"]),
        "tmr_ok": bool(g["ok"]), "tmr_events": float(g["tres"].reports["rod"]["events"]),
    }


@pytest.mark.parametrize("backend", ["lockstep", "lockstep_cuda"])
def test_quickstart_outcomes_equal_jax(jax_quickstart, backend):
    got = example("quickstart_torch").main(["--device", "cpu", "--backend", backend])
    want = jax_quickstart
    for k in ("peak", "mean"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), k
    for k in sorted(set(want) - {"peak", "mean"}):
        assert got[k] == want[k], k


def test_quickstart_spatial_refused():
    with pytest.raises(SystemExit, match="item 7"):
        example("quickstart_torch").main(["--device", "cpu", "--placement", "spatial"])


def frames(text: str) -> list:
    """The ASCII frames of image_blend's output, by transition."""
    blocks = text.split("\n--- transition ")[1:]
    return [b.split("\n\n")[0].rstrip("\n") for b in blocks]


def test_image_blend_frames_equal_jax(monkeypatch, capsys):
    run_jax("image_blend", monkeypatch)
    jax_text = capsys.readouterr().out
    shown = example("image_blend_torch").main(["--device", "cpu"])
    port_text = capsys.readouterr().out
    assert len(frames(jax_text)) == 4
    assert frames(port_text) == frames(jax_text)
    assert [f.split("\n", 1)[1] for f in frames(port_text)] == shown
    tail = lambda t: t[t.index("\nmean |image1.r"):]  # noqa: E731
    assert tail(port_text) == tail(jax_text)


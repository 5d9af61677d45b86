"""The port's loop examples (``examples/{quickstart,image_blend}_torch.py``)
on ``--device cpu``, each passing its own asserts.  JAX's
``quickstart.py`` and ``image_blend.py`` run in-process beside them
(``runpy``, their flags parsed at import): image_blend's ASCII frames
are equal character for character; quickstart's integer outcomes (the
resolved back-end, the unit lead, the detected step, ledger events,
recoveries, the verdicts) are equal and its floats within 1e-4; with
``--placement spatial`` (section 4b) JAX's runs in a subprocess with 2
forced host devices and the outcomes are equal.  The
two serving examples are held against JAX's in
``test_torch_examples_serve_lm.py`` and
``test_torch_examples_walkthrough.py``."""

import importlib.util
import json
import os
import pathlib
import runpy
import subprocess
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


_QUICKSTART_4B = r"""
import json, sys
import numpy as np
import jax
sys.argv = ["quickstart.py", "--placement", "spatial"]
g = {"__name__": "__main__", "__file__": QS}
try:
    exec(compile(open(QS).read(), QS, "exec"), g)
except Exception as e:  # noqa: BLE001 -- the line that indexes a sharded array
    assert type(e).__name__ == "ShardingTypeError", e
sp, sres, sm, final, miso, N = (g[k] for k in ("sp", "sres", "sm", "final", "miso", "N"))
# the rest of section 4b, with the replica read on the host (the installed
# jax refuses ``sres.states["rod"]["t"][0]`` on a pod-sharded array)
srepaired = bool(np.allclose(np.asarray(sres.states["rod"]["t"])[0], np.asarray(final["rod"]["t"])))
rod = g["prog"].cell_id("rod")
campaign = [miso.FaultSpec.at(step=s, cell_id=rod, replica=s % 2, index=N // 2, bit=30)
            for s in (10, 40, 70)]
camp = sp.run_campaign(sp.init(jax.random.PRNGKey(0)), 100, campaign, start_step=0)
print("RESULT" + json.dumps({
    "spatial_backend": sm["backend"], "spatial_pods": int(sm["n_pods"]),
    "spatial_detected": int(sp.ledger.recent["rod"][0]), "spatial_repaired": srepaired,
    "campaign_events": [float(e) for e in np.asarray(camp.reports["rod"]["events"])]}))
"""


def test_quickstart_spatial_outcomes_equal_jax():
    """Section 4b: JAX's quickstart with ``--placement spatial`` (2 forced
    host devices, a subprocess: jax pins its devices at first use) and the
    port's on a 2-pod CPU mesh: the same resolved back-end, pods, detected
    step, verdict and per-strike campaign events.  Under the installed jax
    the reference's section stops where it indexes a pod-sharded array;
    the child finishes the section's statements with that read on the
    host."""
    env = dict(os.environ, PYTHONPATH=str(EXAMPLES.parent / "src"))
    env.pop("XLA_FLAGS", None)
    code = f"QS = {str(EXAMPLES / 'quickstart.py')!r}\n" + _QUICKSTART_4B
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(EXAMPLES.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][-1][6:])
    got = example("quickstart_torch").main(["--device", "cpu", "--placement", "spatial"])
    assert {k: got[k] for k in want} == want
    assert want["spatial_backend"] == "spatial_lockstep" and want["spatial_detected"] == 50


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


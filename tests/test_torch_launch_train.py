"""The training launcher (``python -m repro_torch.launch.train``) and the two
training examples, on ``--device cpu`` at a tiny size: a plain run and
its log file; the DMR/TMR strikes of ``--inject-fault`` detected and
repaired (reduced internlm2 and mamba2); ``--simulate-failure`` with
``--ckpt-dir`` ending bitwise where an uninterrupted run ends, and a
rerun resuming from the checkpoint; ``--microbatches``; the default
device is the card, and without one the launcher raises."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.fault import bitcast_int
from repro_torch.launch import train as L
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--arch", "internlm2-1.8b", "--reduced", "--batch", "2", "--seq", "16",
        "--warmup", "2", "--lr", "1e-2"]


def bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bitcast_int(x), bitcast_int(y)) for x, y in zip(la, lb))


def test_plain_run_and_log_file(tmp_path, capsys):
    log = tmp_path / "log.json"
    states, exe, rows = L.main(TINY + ["--steps", "6", "--log-every", "3", "--log-file", str(log)])
    assert [r["step"] for r in rows] == [3, 6]
    assert exe.recoveries == [] and exe.name == "host"
    out = capsys.readouterr().out
    assert "bigram entropy floor" in out and "done: 6 steps" in out
    rec = json.loads(log.read_text())
    assert rec["rows"] == rows and rec["recoveries"] == []
    assert rec["ledger"]["trainer"]["events"] == 0
    assert int(states["trainer"]["opt"]["step"]) == 6


@pytest.mark.parametrize("arch,redundancy,recoveries", [
    ("internlm2-1.8b", "dmr", 1), ("internlm2-1.8b", "dmr_hash", 1),
    ("internlm2-1.8b", "tmr", 0), ("mamba2-2.7b", "dmr", 1),
])
def test_inject_fault_is_detected_and_repaired(tmp_path, arch, redundancy, recoveries):
    """DMR: one §IV tie-break at the struck step; TMR: the vote corrects
    it in the step (no recovery); either way one ledger event, and the
    replicas agree after."""
    log = tmp_path / "log.json"
    argv = [a if a != "internlm2-1.8b" else arch for a in TINY]
    states, exe, _ = L.main(argv + ["--steps", "5", "--redundancy", redundancy,
                                    "--inject-fault", "2", "--log-every", "5",
                                    "--log-file", str(log)])
    assert exe.recoveries == [(2, "trainer")] * recoveries
    rec = json.loads(log.read_text())
    assert rec["ledger"]["trainer"]["events"] == 1
    assert exe.ledger.recent["trainer"] == [2]
    R = 3 if redundancy == "tmr" else 2
    for x in tree_leaves(states["trainer"]):
        assert all(torch.equal(x[0], x[r]) for r in range(1, R))


def test_simulated_failure_resumes_bitwise(tmp_path, capsys):
    """A crash after step 3 with a checkpoint every 2 steps: the launcher
    restores the latest checkpoint and runs on to step 8, ending bitwise
    where an uninterrupted run ends; a rerun with the same --ckpt-dir
    resumes from the last checkpoint instead of starting over."""
    ck = tmp_path / "ck"
    common = TINY + ["--steps", "8", "--log-every", "2"]
    crashed, _, rows = L.main(common + ["--ckpt-dir", str(ck), "--ckpt-every", "2",
                                        "--simulate-failure", "3"])
    assert "simulated fail-stop at step 4" in capsys.readouterr().out
    straight, _, _ = L.main(common)
    assert bits_equal(crashed, straight)
    assert [r["step"] for r in rows][:2] == [2, 4]
    again, _, _ = L.main(common + ["--ckpt-dir", str(ck), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step" in out
    assert bits_equal(again["trainer"], straight["trainer"])


def test_microbatches_flag(tmp_path):
    states, _, rows = L.main(TINY + ["--steps", "2", "--log-every", "2", "--microbatches", "2"])
    assert rows[-1]["step"] == 2 and states["trainer"]["metrics"]["loss"].isfinite()


def test_the_default_device_is_the_card():
    assert L.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        L.main([a for a in TINY if a not in ("--device", "cpu")] + ["--steps", "1"])


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu", *args],
                          capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))


def test_train_lm_example(tmp_path):
    proc = run_example("train_lm_torch.py", "--d-model", "64", "--layers", "1", "--steps", "80",
                       "--batch", "8", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "beat the uniform floor" in proc.stdout


def test_dependable_training_example():
    proc = run_example("dependable_training_torch.py", "--steps", "16", "--batch", "4", "--seq", "16")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "detected 4 strikes, 4 tie-break recoveries, drift vs clean = 0.000e+00" in out
    assert "votes corrected 1 strike(s), drift vs clean = 0.000e+00" in out
    assert "ledger flagged {'trainer'" in out

"""The schedules of ``tests/test_torch_schedules.py`` on a CUDA card,
held against the port's own CPU path (this file imports no JAX, so it
runs where the card is: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_schedules_cuda.py``).  Without a card every test skips.

  * ``host``: the §IV tie-break votes through K4 (one launch a recovery)
    and gives the CPU path's states bit for bit;
  * ``wavefront``: a run makes one host synchronisation (torch's sync
    debug mode counts them), with the lock-step states;
  * the IR: Listing 1 with Int slots, card equal to CPU bit for bit."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.fault import bitcast_int
from repro_torch.core.ir import LISTING_1
from repro_torch.kernels import tmr_vote as tv
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bitcast_int(x.cpu()), bitcast_int(y.cpu())) for x, y in zip(la, lb))


def listing1(W=300, H=200):
    rng = np.random.default_rng(0)
    inputs = {img: {c: rng.integers(0, 256, W * H).astype(np.int32) for c in "rgb"}
              for img in ("image1", "image2")}
    return api.compile_source(LISTING_1.replace("300*200", f"{W}*{H}"), inputs)


def both(prog, n, faults=None, **kw):
    """The final states of ``n`` steps on the card and on the CPU, and the
    card's executor."""
    out = []
    for device in ("cuda", "cpu"):
        exe = api.compile(prog, device=device, **kw)
        out.append(exe.run(exe.init(0), n, start_step=0, faults=faults).states)
    return out[0], out[1], exe


def sync_warnings(fn):
    """``(fn(), texts of the warnings torch's sync debug mode raised)``:
    one per synchronising CUDA call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught]


@pytest.mark.cuda
def test_host_tiebreak_on_the_card_goes_through_k4(card):
    strike = api.FaultSpec.at(step=5, cell_id=0, replica=1, leaf=2, index=30150, bit=30)
    tv.tmr_vote.launches = 0
    exe = api.compile(listing1(), backend="host", policies={"image1": api.RedundancyPolicy(level=2)})
    res = exe.run(exe.init(0), 12, start_step=0, faults=[strike])
    assert tv.tmr_vote.launches == 1 and exe.recoveries == [(5, "image1")]
    cpu = api.compile(listing1(), backend="host", device="cpu",
                      policies={"image1": api.RedundancyPolicy(level=2)})
    ref = cpu.run(cpu.init(0), 12, start_step=0, faults=[strike])
    assert bits_equal(res.states, ref.states) and cpu.recoveries == exe.recoveries


@pytest.mark.cuda
def test_listing1_on_the_card_equals_the_cpu_path(card):
    for level in (1, 2, 3):
        pol = {"image1": api.RedundancyPolicy(level=level)}
        got, ref, exe = both(listing1(), 10, backend="auto", policies=pol)
        assert exe.name == "lockstep" and bits_equal(got, ref)  # auto on the CPU: lockstep
    assert api.compile(listing1(), backend="auto").name == "lockstep_cuda"


@pytest.mark.cuda
def test_wavefront_run_syncs_the_host_once(card):
    n = 1 << 16
    prog = api.MisoProgram()
    for name, work, level in (("fast", 1, 2), ("slow", 8, 1)):
        def transition(prev, name=name, work=work):
            t = prev[name]["t"]
            for _ in range(work):
                t = 0.25 * torch.roll(t, 1) + 0.5 * t + 0.25 * torch.roll(t, -1)
            return {"t": t}

        prog.add(api.CellType(name, lambda g, d: {"t": torch.linspace(0, 1, n, device=d)},
                              transition, redundancy=api.RedundancyPolicy(level=level)))
    wf = api.compile(prog, backend="auto", window=8)
    assert wf.name == "wavefront"
    states = wf.init(0)
    sync_warnings(lambda: states["slow"]["t"].cpu())  # the mode's first use may add a notice
    _, one = sync_warnings(lambda: states["slow"]["t"].cpu())
    assert len(one) == 1 and not sync_warnings(lambda: states["slow"]["t"] + 1)[1]
    res, texts = sync_warnings(lambda: wf.run(states, 16, start_step=0))
    assert texts == one  # one copy of the reports to the host, at the end
    assert wf.max_lead() > 0
    lock = api.compile(prog, backend="lockstep")
    assert bits_equal(res.states, lock.run(states, 16, start_step=0).states)

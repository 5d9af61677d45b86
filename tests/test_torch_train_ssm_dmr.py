"""A reduced f32 mamba2 trainer under DMR with the launcher's strike at
step 3, against the JAX package's: one §IV recovery at (3, trainer), the
ledger bitwise JAX's, the replicas equal and the repaired state the
unstruck run's.  The scan's gradient goes through
``kernels.ssd_scan.SSDScan`` (on the CPU the plain forward and
``ssd_scan_bwd_plain``)."""

import jax
import numpy as np
import torch

from repro import api as jmiso
from repro.core import FaultLedger as JLedger
from repro.core import FaultSpec as JFault
from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.core import FaultLedger
from repro_torch.launch.train import strike
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist
from test_torch_train import programs

cap_threads_for_xdist()


def test_mamba2_dmr_strike_recovery_and_ledger_bitwise_jax():
    """The launcher's strike at step 3 of a DMR mamba2 trainer: one §IV
    recovery at (3, trainer), the same ledger as JAX's; the replicas agree
    and equal an unstruck run."""
    jp, tp, js, ts = programs("mamba2-2.7b", policy=2)
    jexe = jmiso.compile(jp, backend="host", ledger=JLedger())
    texe = tmiso.compile(tp, backend="host", device="cpu", ledger=FaultLedger())
    jf = JFault.at(step=3, cell_id=jp.cell_id("trainer"), replica=0, leaf=5, index=11, bit=19)
    tf = strike(tp, 3)
    jexe.run(js, 5, faults=[jf])
    tres = texe.run(ts, 5, faults=[tf])
    assert texe.recoveries == [(3, "trainer")] == [tuple(r) for r in jexe.recoveries]
    assert texe.ledger.totals == jexe.ledger.totals
    assert texe.ledger.recent == jexe.ledger.recent == {"trainer": [3]}
    tr = tres.states["trainer"]
    assert all(torch.equal(x[0], x[1]) for x in tree_leaves(tr))
    clean = tmiso.compile(tp, backend="host", device="cpu").run(
        bridge.states_from_numpy(jax.tree.map(np.asarray, js), device="cpu"), 5).states
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr), tree_leaves(clean["trainer"])))

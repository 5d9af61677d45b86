"""Three steps of the reduced f32 mamba2 and zamba2 train programs on
the ``host`` back-end against the JAX package's, from JAX-initialised
states (``repro_torch.bridge``): losses within 1e-4 relative, batches
bitwise.  The scan's gradient goes through ``kernels.ssd_scan.SSDScan``
(on the CPU the plain forward and ``ssd_scan_bwd_plain``)."""

import numpy as np
import pytest

from repro import api as jmiso
from repro.core import FaultLedger as JLedger
from repro_torch import api as tmiso
from repro_torch.core import FaultLedger
from repro_torch.testing import cap_threads_for_xdist
from test_torch_train import programs

cap_threads_for_xdist()


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_three_steps_of_the_train_program(arch):
    jp, tp, js, ts = programs(arch)
    jexe = jmiso.compile(jp, backend="host", ledger=JLedger())
    texe = tmiso.compile(tp, backend="host", device="cpu", ledger=FaultLedger())
    for step in range(3):
        js, ts = jexe.run(js, 1).states, texe.run(ts, 1).states
        assert (np.asarray(js["data"]["tokens"]) == ts["data"]["tokens"].numpy()).all(), step
        a, b = float(js["trainer"]["metrics"]["loss"]), float(ts["trainer"]["metrics"]["loss"])
        assert abs(a - b) <= 1e-4 * abs(a), (step, a, b)
    assert int(ts["trainer"]["opt"]["step"]) == 3

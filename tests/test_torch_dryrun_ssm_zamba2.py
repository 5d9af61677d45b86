"""``test_torch_dryrun_ssm.py``'s equality of the cheaper and the full
evaluation on reduced zamba2 (a unit: its mamba layers and the shared
block), train and prefill on a (2, 4) mesh."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_dryrun_ssm import check

cap_threads_for_xdist()


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_zamba2_cheaper_counts_equal_the_full_ones(kind, monkeypatch):
    check("zamba2-2.7b", kind, (2, 4), monkeypatch)

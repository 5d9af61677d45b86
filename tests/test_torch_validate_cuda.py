"""``MisoProgram.validate`` at full width costs no device memory: the
full-width internlm2-1.8b train program (batch 4 x 512, about 24 GB of
state were it real) and the paged slot serve program validate on fake
CPU tensors, and ``torch.cuda.max_memory_allocated()`` does not move.
Needs the card (marked ``cuda``); imports no JAX, so it runs there with
``PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_validate_cuda.py``."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import lm_cells as lc
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


@pytest.mark.cuda
def test_full_width_validate_allocates_nothing_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config("internlm2-1.8b")
    tcfg = lc.TrainConfig(data=DataConfig(batch=4, seq_len=512, vocab=cfg.vocab_size),
                          opt=OptConfig(peak_lr=1e-3, warmup_steps=4, decay_steps=20))
    serve = lc.make_slot_serve_program(cfg, lc.ServeConfig(batch=8, max_len=512, paged=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    lc.make_train_program(cfg, tcfg).validate()
    serve.validate()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 1 << 20

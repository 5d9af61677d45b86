"""Training the recurrent architectures in the port against the JAX
package, reduced f32 mamba2 and zamba2, the scan's gradient through
``kernels.ssd_scan.SSDScan`` (on the CPU its plain forward and the
written-out plain backward ``ssd_scan_bwd_plain``), with JAX-initialised
states carried over through ``repro_torch.bridge``:

  * zamba2's ``loss_fn`` and grads against ``jax.value_and_grad`` within
    1e-5 relative (each grad leaf in L2 against its own norm;
    tests/test_torch_train.py holds mamba2 so);
  * one step's grads bitwise equal under remat "full", "dots" and "none"
    (the Function recomputed inside a checkpointed layer), every leaf
    receiving a gradient.

Three train steps against JAX's are ``test_torch_train_ssm_steps.py``,
DMR with the launcher's strike ``test_torch_train_ssm_dmr.py``."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.distributed.sharding import LOCAL
from repro_torch.models import lm_cells as TL
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist
from test_torch_train import close, configs

cap_threads_for_xdist()


def test_zamba2_loss_and_grads_within_1e5_of_jax():
    jc, tc = configs("zamba2-2.7b")
    params = JT.init_params(jc, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}), has_aux=True)(params)
    tm, tg = TL._value_and_grad(tc, tparams, {"tokens": torch.from_numpy(toks)})
    close(jloss, tm["loss"], 1e-5, "loss")
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, b in zip(paths, jl, tl):
        close(a, b, 1e-5, f"grad {name}")
    assert any("shared_attn" in p for p in paths)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_grads_bitwise_under_every_remat_policy(arch):
    _, tc = configs(arch)
    g = torch.Generator().manual_seed(0)
    params = T.init_params(tc, g, "cpu")
    toks = torch.randint(0, tc.vocab_size, (2, 32), generator=g, dtype=torch.int32)
    grads = {}
    for remat in ("full", "dots", "none"):
        _, gr = TL._value_and_grad(tc, params, {"tokens": toks}, dc.replace(LOCAL, remat=remat))
        grads[remat] = tree_leaves(gr)
    for remat in ("dots", "none"):
        assert all(torch.equal(a, b) for a, b in zip(grads["full"], grads[remat])), remat
    # every leaf, the mamba layers' upstream of the scan included, gets a gradient
    assert all(float(x.abs().sum()) > 0 for x in grads["full"])

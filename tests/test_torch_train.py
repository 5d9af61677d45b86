"""Training in the port against the JAX package, reduced f32 configs with
JAX-initialised states carried over through ``repro_torch.bridge``:

  * ``loss_fn`` and its grads (``torch.autograd.grad`` over the params
    tree) against ``jax.value_and_grad`` for internlm2, mamba2 (the K8
    scan through ``SSDScan``: its plain forward and the written-out
    plain backward ``ssd_scan_bwd_plain``), deepseek's
    dense prefix with its MTP head, granite-moe (router, experts, aux)
    and musicgen (four codebooks): within 1e-5 relative (each grad leaf
    in L2 against its own norm);
  * five steps of the train program on the ``host`` back-end: losses
    within 1e-4 relative, batches and ledgers bitwise;
  * DMR with the launcher's strike: recoveries and ledger bitwise JAX's,
    and the repaired state the unstruck run's;
  * microbatches=2 against 1 within 1e-5, and against JAX's;
  * ``grad_compression="int8_ef"`` refused without a mesh (it reduces
    over a data mesh: ``test_torch_train_int8ef.py``);
  * F4 carried through: on the card K8 with grad trains through its
    backward kernel, K7 still refuses inputs that require grad (marked
    ``cuda``; skips without a card)."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro.configs import get_reduced as jget
from repro.core import FaultLedger as JLedger
from repro.core import FaultSpec as JFault
from repro.core import RedundancyPolicy as JPolicy
from repro.data.pipeline import DataConfig as JData
from repro.models import lm_cells as JL
from repro.models import transformer as JT
from repro.optim.adamw import OptConfig as JOpt
from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.configs import deepseek_v3_671b as ds
from repro_torch.configs import get_reduced as tget
from repro_torch.core import FaultLedger, RedundancyPolicy
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import strike
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)


def configs(arch):
    jc, tc = jget(arch), tget(arch)
    if arch == "deepseek-v3-671b":
        tc = ds.dense_prefix(tc)
        jc = dc.replace(jc, n_layers=tc.n_layers, mixer_type="mlp", moe=None)
    return dc.replace(jc, dtype="float32"), dc.replace(tc, dtype="float32")


def close(a, b, rel, what):
    """``b`` within ``rel`` of ``a`` relative to ``a``'s L2 norm (for a
    scalar, its magnitude): a leaf's error against the leaf's size, so a
    leaf of small grads (mamba's a_log) is not held to another's scale."""
    a = np.asarray(a, np.float64)
    b = (b.detach().double().numpy() if isinstance(b, torch.Tensor)
         else np.asarray(b, np.float64))
    assert a.shape == b.shape, what
    scale = max(float(np.linalg.norm(a)), 1e-30)
    err = float(np.linalg.norm(a - b))
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b", "deepseek-v3-671b",
                                  "granite-moe-1b-a400m", "musicgen-large"])
def test_loss_and_grads_within_1e5_of_jax(arch):
    jc, tc = configs(arch)
    params = JT.init_params(jc, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    shape = (2, 16) + ((jc.n_codebooks,) if jc.n_codebooks > 1 else ())
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, shape).astype(np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}), has_aux=True)(params)
    tm, tg = TL._value_and_grad(tc, tparams, {"tokens": torch.from_numpy(toks)})
    close(jloss, tm["loss"], 1e-5, "loss")
    for k in jm:
        close(jm[k], torch.as_tensor(tm[k]), 1e-5, k)
    if jc.mtp:
        assert "mtp" in tm
    if jc.moe is not None:
        assert float(tm["aux"]) > 0
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, b in zip(paths, jl, tl):
        close(a, b, 1e-5, f"grad {name}")
    # the params given in are not written, nor marked as requiring grad
    assert not any(x.requires_grad for x in tree_leaves(tparams))


def programs(arch="internlm2-1.8b", policy=None, microbatches=1, batch=2, seq=16):
    jc, tc = configs(arch)
    jt = JL.TrainConfig(data=JData(batch=batch, seq_len=seq, vocab=jc.vocab_size),
                        opt=JOpt(**OPT), microbatches=microbatches)
    tt = TL.TrainConfig(data=DataConfig(batch=batch, seq_len=seq, vocab=tc.vocab_size),
                        opt=OptConfig(**OPT), microbatches=microbatches)
    jp, tp = JL.make_train_program(jc, jt), TL.make_train_program(tc, tt)
    if policy is not None:
        jp = jp.with_policies({"trainer": JPolicy(level=policy)})
        tp = tp.with_policies({"trainer": RedundancyPolicy(level=policy)})
    js = jp.init_states(jax.random.PRNGKey(0))
    ts = bridge.states_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    return jp, tp, js, ts


def test_five_steps_of_the_train_program():
    jp, tp, js, ts = programs()
    jexe = jmiso.compile(jp, backend="host", ledger=JLedger())
    texe = tmiso.compile(tp, backend="host", device="cpu", ledger=FaultLedger())
    for step in range(5):
        js, ts = jexe.run(js, 1).states, texe.run(ts, 1).states
        assert (np.asarray(js["data"]["tokens"]) == ts["data"]["tokens"].numpy()).all(), step
        a, b = float(js["trainer"]["metrics"]["loss"]), float(ts["trainer"]["metrics"]["loss"])
        assert abs(a - b) <= 1e-4 * abs(a), (step, a, b)
        for k in ("grad_norm", "lr"):
            close(js["trainer"]["metrics"][k], ts["trainer"]["metrics"][k], 1e-4, k)
    assert jexe.metrics()["fault_totals"] == texe.metrics()["fault_totals"]
    assert int(ts["trainer"]["opt"]["step"]) == 5


def test_dmr_strike_recovery_and_ledger_bitwise_jax():
    """The launcher's strike (leaf 5, element 11, bit 19 of replica 0) at
    step 3 of a DMR trainer: one §IV recovery at (3, trainer) and the
    same ledger as JAX's; the replicas agree and equal an unstruck run."""
    jp, tp, js, ts = programs(policy=2)
    jexe = jmiso.compile(jp, backend="host", ledger=JLedger())
    texe = tmiso.compile(tp, backend="host", device="cpu", ledger=FaultLedger())
    jf = JFault.at(step=3, cell_id=jp.cell_id("trainer"), replica=0, leaf=5, index=11, bit=19)
    tf = strike(tp, 3)
    assert (tf.step, tf.cell_id, tf.replica, tf.leaf, tf.index, tf.bit) == (
        3, jf.cell_id, 0, 5, 11, 19)
    jres = jexe.run(js, 5, faults=[jf])
    tres = texe.run(ts, 5, faults=[tf])
    assert texe.recoveries == [(3, "trainer")] == [tuple(r) for r in jexe.recoveries]
    assert texe.ledger.totals == jexe.ledger.totals
    assert texe.ledger.recent == jexe.ledger.recent == {"trainer": [3]}
    tr = tres.states["trainer"]
    assert all(torch.equal(x[0], x[1]) for x in tree_leaves(tr))
    clean = tmiso.compile(tp, backend="host", device="cpu").run(
        bridge.states_from_numpy(jax.tree.map(np.asarray, js), device="cpu"), 5).states
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr), tree_leaves(clean["trainer"])))
    close(jres.states["trainer"]["metrics"]["loss"][0], tr["metrics"]["loss"][0], 1e-4, "loss")


def test_microbatches_two_against_one_and_jax():
    """One step: the mean of two half-batch losses is the whole batch's,
    the accumulated f32 grads' norm the plain grads' (within 1e-5), and
    both JAX's microbatched step's."""
    out = {}
    for mb in (1, 2):
        jp, tp, js, ts = programs(microbatches=mb, batch=4)
        js = jmiso.compile(jp, backend="host").run(js, 1).states
        ts = tmiso.compile(tp, backend="host", device="cpu").run(ts, 1).states
        out[mb] = ts["trainer"]["metrics"]
        for k in ("loss", "grad_norm"):
            close(js["trainer"]["metrics"][k], out[mb][k], 1e-5, f"mb={mb} {k} vs jax")
    for k in ("loss", "grad_norm"):
        close(out[1][k].numpy(), out[2][k], 1e-5, f"mb=2 vs mb=1 {k}")


def test_int8_ef_is_refused():
    """Without a mesh: the compressed reduction runs over a data mesh
    (``tests/test_torch_train_int8ef.py`` runs it on one)."""
    _, tc = configs("internlm2-1.8b")
    tt = TL.TrainConfig(data=DataConfig(batch=2, seq_len=8, vocab=tc.vocab_size),
                        grad_compression="int8_ef")
    with pytest.raises(ValueError, match="data mesh"):
        TL.make_trainer_cell(tc, tt)


def test_the_transition_does_not_write_prev():
    _, tp, _, ts = programs()
    before = [x.clone() for x in tree_leaves(ts)]
    tmiso.compile(tp, backend="host", device="cpu").run(ts, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(ts)))


def test_mamba_grads_reach_the_parameters_upstream_of_the_scan():
    """F4's CPU side: the scan's gradient (``SSDScan``, on the CPU its plain
    forward and plain backward) reaches every mamba parameter upstream of
    it."""
    _, tc = configs("mamba2-2.7b")
    g = torch.Generator().manual_seed(0)
    from repro_torch.models import transformer as T

    params = T.init_params(tc, g, "cpu")
    toks = torch.randint(0, tc.vocab_size, (2, 16), generator=g, dtype=torch.int32)
    _, grads = TL._value_and_grad(tc, params, {"tokens": toks})
    mamba = grads["segments"][0]["mamba"]
    for name, leaf in mamba.items():
        assert float(leaf.abs().sum()) > 0, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_f4_kernels_refuse_inputs_that_require_grad_on_the_card(card):
    """F4 carried through: K8 with grad now trains (outputs with a grad_fn,
    its backward kernel launched once, every grad within 1e-3 relative L2
    of autograd through the plain scan: phase 2h's f32 limit); K7 still
    refuses inputs that require grad; under no_grad K8's forward is within
    1e-3 of its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks

    B, L, H, P, G, N = 1, 128, 2, 64, 1, 64
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(B, L, H, P, device=card, generator=gen)
    dt = torch.rand(B, L, H, device=card, generator=gen) * 0.1
    a = -torch.rand(H, device=card, generator=gen)
    b = torch.randn(B, L, G, N, device=card, generator=gen)
    c = torch.randn(B, L, G, N, device=card, generator=gen)
    dy = torch.randn(B, L, H, P, device=card, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    n = ks.ssd_scan_bwd.launches
    y, _ = ks.ssd_scan(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    assert ks.ssd_scan_bwd.launches == n + 1
    plain = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    want = torch.autograd.grad(ks.ssd_scan_plain(*plain)[0], plain, dy)
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) <= 1e-3
    q = torch.randn(1, 2, 64, 64, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="K7 has no backward"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():
        y, _ = ks.ssd_scan(x, dt, a, b, c)
        ref, _ = ks.ssd_scan_plain(x, dt, a, b, c)
    assert torch.allclose(y, ref, rtol=1e-3, atol=1e-3)

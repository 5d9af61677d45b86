"""The port's Mamba2 block and model (reduced mamba2-2.7b, f32) against the
JAX package's, on JAX-initialised weights carried over through
``repro_torch.bridge``.  f32 tolerances are 1e-4 (different reduction
orders, and the port's chunked scan against JAX's quadratic CPU
reference); greedy tokens are EQUAL for 16 decode steps.

Also: the conv history of a prompt shorter than the conv window, which
the JAX package keeps short and pads at the END when installing it into
the serving cache — the port does the same, and decodes the same tokens.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.lm_cells import install_prefill as jinstall
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.models.lm_cells import install_prefill as tinstall
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "mamba2-2.7b"
CFG = dc.replace(get_reduced(ARCH), dtype="float32")
TCFG = dc.replace(tget(ARCH), dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(TCFG, jax.tree.map(np.asarray, params), device="cpu")
    return params, tparams


def tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_config_matches_the_jax_package():
    assert dc.asdict(tget_config(ARCH)) == dc.asdict(get_config(ARCH))
    assert dc.asdict(tget(ARCH)) == dc.asdict(get_reduced(ARCH))
    assert tget_config(ARCH).n_params() == get_config(ARCH).n_params()
    assert TT.segment_plan(tget_config(ARCH)) == [TT.Segment("mamba", 64)]


def test_mamba_block_prefill_fill_cache_and_decode_step_match_jax(pair):
    params, tparams = pair
    jp = jax.tree.map(lambda x: x[0], params["segments"][0]["mamba"])
    tp = {k: v[0] for k, v in tparams["segments"][0]["mamba"].items()}
    x = np.random.default_rng(0).normal(size=(2, 21, CFG.d_model)).astype(np.float32)
    jy, _ = jssm.mamba_block(jp, jnp.asarray(x), CFG)
    ty, tc = tssm.mamba_block(tp, torch.from_numpy(x), TCFG)
    close(ty, jy)
    assert tc is None
    jy, jc = jssm.mamba_block(jp, jnp.asarray(x), CFG, fill_cache=True)
    ty, tc = tssm.mamba_block(tp, torch.from_numpy(x), TCFG, fill_cache=True)
    close(ty, jy)
    for key in ("conv_x", "conv_bc", "ssm"):
        close(tc[key], jc[key])
    x1 = np.random.default_rng(1).normal(size=(2, 1, CFG.d_model)).astype(np.float32)
    before = {k: v.clone() for k, v in tc.items()}
    jy, jc = jssm.mamba_block(jp, jnp.asarray(x1), CFG, cache=jc)
    ty, tc2 = tssm.mamba_block(tp, torch.from_numpy(x1), TCFG, cache=tc)
    close(ty, jy)
    for key in ("conv_x", "conv_bc", "ssm"):
        close(tc2[key], jc[key])
        assert torch.equal(tc[key], before[key])  # the input cache is untouched


def test_init_params_layout_and_f32_leaves_match_jax():
    """Generator-made weights have the JAX tree's keys, shapes and dtypes:
    a_log, dt_bias and d_skip stay f32 under a bf16 config, also through
    the bridge."""
    cfg, tcfg = get_reduced(ARCH), tget(ARCH)
    jp = jax.eval_shape(lambda k: JT.init_params(cfg, k), jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat = jax.tree.leaves(jp)
    assert len(jflat) == len(tree_leaves(tp))
    for a, b, path in zip(jflat, tree_leaves(tp), tree_paths(tp)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    real = JT.init_params(cfg, jax.random.PRNGKey(1))
    bridged = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, real), device="cpu")
    mp = bridged["segments"][0]["mamba"]
    assert {mp[k].dtype for k in ("a_log", "dt_bias", "d_skip")} == {torch.float32}
    assert mp["w_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.tree_to_numpy(mp)["w_x"],
                                  np.asarray(real["segments"][0]["mamba"]["w_x"]).view(np.uint16))


def test_forward_logits_within_1e4_of_jax(pair):
    params, tparams = pair
    toks = tokens(2, 40, 0)  # 40 = two chunks of 16 and a ragged 8
    jl, _, _ = JT.forward(CFG, params, jnp.asarray(toks))
    tl, _ = TT.forward(TCFG, tparams, torch.from_numpy(toks))
    close(tl, jl)


def greedy(toks, steps, params, tparams, max_len=64):
    """Prefill with fill_cache, install into a max_len cache, then greedy
    decode in both packages; returns both token streams and caches."""
    B, S = toks.shape
    jlog, jfill, _ = JT.forward(CFG, params, jnp.asarray(toks), fill_cache=True)
    jcache = jinstall(CFG, JT.init_cache(CFG, B, max_len), jfill, S)
    tlog, tfill = TT.forward(TCFG, tparams, torch.from_numpy(toks), fill_cache=True)
    tcache = tinstall(TCFG, TT.init_cache(TCFG, B, max_len, "cpu"), tfill, S)
    jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tlog[:, -1:], -1).to(torch.int32)
    step = jax.jit(lambda p, c, t: JT.decode_step(CFG, p, c, t))
    jout, tout = [], []
    for _ in range(steps):
        jout.append(np.asarray(jtok)[:, 0])
        tout.append(ttok[:, 0].numpy())
        jlog, jcache = step(params, jcache, jtok)
        prev = tcache
        tlog, tcache = TT.decode_step(TCFG, tparams, tcache, ttok)
        assert tcache["segments"][0]["ssm"] is not prev["segments"][0]["ssm"]  # out of place
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    return np.stack(jout, 1), np.stack(tout, 1), jcache, tcache, jfill, tfill


def test_decode_16_greedy_steps_equal_jax_tokens(pair):
    params, tparams = pair
    jt, tt_, jcache, tcache, _, _ = greedy(tokens(2, 19, 3), 16, *pair)
    np.testing.assert_array_equal(tt_, jt)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key in ("conv_x", "conv_bc", "ssm"):
        close(tcache["segments"][0][key], jcache["segments"][0][key])


def test_two_token_prompt_conv_history_padded_at_the_end_like_jax(pair):
    """A 2-token prompt keeps 2 rows of conv history for a 3-row cache leaf;
    both packages pad the missing row at the END (zeros after the real
    rows) and then decode the same tokens from that state."""
    jt, tt_, _, _, jfill, tfill = greedy(tokens(1, 2, 5), 16, *pair)
    assert tuple(tfill["segments"][0]["conv_x"].shape[2:3]) == (2,)
    jcache = jinstall(CFG, JT.init_cache(CFG, 1, 64), jfill, 2)
    tcache = tinstall(TCFG, TT.init_cache(TCFG, 1, 64, "cpu"), tfill, 2)
    for key in ("conv_x", "conv_bc"):
        t, j = tcache["segments"][0][key], np.asarray(jcache["segments"][0][key])
        assert t.shape[2] == j.shape[2] == 3
        assert torch.all(t[:, :, 2] == 0) and np.all(j[:, :, 2] == 0)
        assert torch.all(t[:, :, :2] != 0)
        close(t, j)
    np.testing.assert_array_equal(tt_, jt)


def test_prefill_runs_one_scan_per_layer_and_refuses_bucket_padding(pair):
    _, tparams = pair
    ks.ssd_scan.launches = 0
    toks = torch.from_numpy(tokens(1, 9, 4))
    with pytest.raises(ValueError, match="recurrent mamba state"):
        TT.forward(TCFG, tparams, toks, prompt_len=5)
    with pytest.raises(ValueError, match="attention-only"):
        TT.init_paged_cache(TCFG, 2, 8, 4, "cpu")
    assert ks.ssd_scan.launches == 0  # CPU tensors: the plain version, no launch


def test_unported_archs_still_raise():
    """No arch is left unported: zamba2's plan is 9 units of 6 mamba
    layers and the shared block, the last three archs (sliding window,
    M-RoPE and vision, four codebooks) plan as GQA decoders, a
    mamba2-like model with codebooks plans its mamba layers, and only an
    unknown name raises."""
    assert TT.segment_plan(tget_config("zamba2-2.7b")) == [TT.Segment("zamba_unit", 9, sub=6)]
    assert TT.segment_plan(dc.replace(tget(ARCH), shared_attn_every=3, name="zamba-like")) == [
        TT.Segment("zamba_unit", 1, sub=3)]
    for arch, n in (("h2o-danube-3-4b", 24), ("qwen2-vl-7b", 28), ("musicgen-large", 48)):
        assert TT.segment_plan(tget_config(arch)) == [TT.Segment("attn_mlp", n)]
    assert TT.segment_plan(dc.replace(tget(ARCH), n_codebooks=4, name="musicgen-like")) == [
        TT.Segment("mamba", tget(ARCH).n_layers)]
    with pytest.raises(ValueError, match="unknown arch"):
        tget("musicgen-small")

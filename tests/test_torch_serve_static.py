"""The static fixed-batch serving path (``launch/serve.py --static``,
``lm_cells.make_serve_program``) against the JAX package on reduced f32
internlm2: the JAX program's init states carried across, the collected
tokens of the port's ``static_main`` bitwise the same steps in JAX
(``make_serve_program``, the batched prefill, ``install_prefill``, the
``lockstep`` run) under none, DMR and TMR; the printed "sample
continuation (seq 0)" and "redundancy events" lines equal to JAX's own
``static_main(cfg, args)``; the prompts bitwise ``jax.random.randint``'s;
and under DMR with a bit flip into a replica's KV cache, the ledger
bitwise JAX's.  ``test_torch_serve_static_archs.py`` holds four more
archs."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro.configs import get_reduced
from repro.core import FaultSpec as JFaultSpec
from repro.core import RedundancyPolicy as JPolicy
from repro.core.redundancy import canonical_state, replicate_state
from repro.launch import serve as JS
from repro.models import lm_cells as jlc
from repro.models import transformer as JT
from repro_torch import bridge, prng
from repro_torch.api import FaultSpec
from repro_torch.configs import get_reduced as tget
from repro_torch.core.redundancy import canonical_state as tcanonical
from repro_torch.launch import serve as TS
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index

cap_threads_for_xdist()

LEVELS = {"none": 1, "dmr": 2, "tmr": 3}
RUN = dict(batch=2, prompt_len=6, decode=6, max_len=16, seed=0)


def argv(redundancy: str, **over) -> list:
    run = {**RUN, **over}
    return ["--static", "--device", "cpu", "--redundancy", redundancy,
            *(x for k, v in run.items() for x in (f"--{k.replace('_', '-')}", str(v)))]


def jax_static(cfg, redundancy: str, *, faults=None, **over):
    """JAX's static path, the steps of ``repro.launch.serve.static_main``
    returning (init states, collected tokens, reports, executor)."""
    run = {**RUN, **over}
    B, P, level = run["batch"], run["prompt_len"], LEVELS[redundancy]
    prog = jlc.make_serve_program(cfg, jlc.ServeConfig(batch=B, max_len=run["max_len"]))
    prog = prog.with_policies({"decoder": JPolicy(level=level)})
    states0 = prog.init_states(jax.random.PRNGKey(run["seed"]))
    shape = (B, P) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    prompts = jax.random.randint(jax.random.PRNGKey(run["seed"] + 1), shape, 0, cfg.vocab_size,
                                 jnp.int32)
    vision = None
    if cfg.n_vision_tokens:
        vision = jnp.zeros((B, min(cfg.n_vision_tokens, P), cfg.d_model), cfg.compute_dtype)
    logits, cache, _ = JT.forward(cfg, states0["weights"]["params"], prompts, fill_cache=True,
                                  vision_embeds=vision)
    dec = dict(canonical_state(states0["decoder"], level))
    dec["cache"] = jlc.install_prefill(cfg, JT.init_cache(cfg, B, run["max_len"]), cache, P)
    dec["tokens"] = JS._first_token(cfg, logits)
    states = {**states0, "decoder": replicate_state(dec, level)}
    exe = jmiso.compile(prog, backend="lockstep", donate=False)
    res = exe.run(states, run["decode"], faults=faults,
                  collect=lambda st: (st["decoder"]["tokens"] if level == 1
                                      else st["decoder"]["tokens"][0]))
    return states0, np.asarray(res.collected), res.reports, exe


def carried(states0):
    return bridge.states_from_numpy(jax.tree.map(np.asarray, states0), device="cpu")


CFG = dc.replace(get_reduced("internlm2-1.8b"), dtype="float32")
TCFG = dc.replace(tget("internlm2-1.8b"), dtype="float32")


@pytest.fixture(scope="module")
def jax_runs():
    return {r: jax_static(CFG, r) for r in LEVELS}


@pytest.mark.parametrize("redundancy", sorted(LEVELS))
def test_static_tokens_bitwise_jax(jax_runs, redundancy):
    states0, want, reports, _ = jax_runs[redundancy]
    out = TS.static_main(TCFG, TS.parser().parse_args(argv(redundancy)), states=carried(states0))
    assert out["tokens"].dtype == np.int32 and np.array_equal(out["tokens"], want)
    # replicas decode the same tokens: the unreplicated run's
    assert np.array_equal(want, jax_runs["none"][1])
    if redundancy != "none":
        assert float(out["reports"]["decoder"]["events"]) == float(
            reports["decoder"]["events"]) == 0.0


def test_static_main_prints_what_jax_prints(jax_runs, capsys):
    """JAX's own ``static_main`` and the port's, on the same f32 config and
    states (JAX's ``init_states(PRNGKey(seed))``, carried across)."""
    args = TS.parser().parse_args(argv("dmr"))
    JS.static_main(CFG, args)
    jax_out = capsys.readouterr().out.splitlines()
    TS.static_main(TCFG, args, states=carried(jax_runs["dmr"][0]))
    port_out = capsys.readouterr().out.splitlines()

    def lines(out, prefix):
        return [ln for ln in out if ln.startswith(prefix)]

    for prefix in ("sample continuation (seq 0):", "redundancy events:"):
        assert lines(port_out, prefix) == lines(jax_out, prefix) and lines(jax_out, prefix)
    assert lines(port_out, "prefill 6 tok x2:")


@pytest.mark.parametrize("shape,vocab,seed", [((4, 12), 92544, 1), ((4, 12, 4), 2048, 1),
                                             ((2, 6), 256, 7)])
def test_prompts_bitwise_jax_randint(shape, vocab, seed):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, vocab, jnp.int32))
    got = prng.randint(prng.PRNGKey(seed), shape, 0, vocab)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_dmr_cache_strike_ledger_bitwise_jax(jax_runs):
    """A bit flip into replica 1's first KV leaf at step 2: DMR detects it
    on every later step (lock-step DMR does not repair); the events, the
    ledger and replica 0's tokens are JAX's."""
    states0 = jax_runs["dmr"][0]
    leaf = leaf_index(tcanonical(carried(states0)["decoder"], 2), "k")
    jleaf = next(i for i, (p, _) in enumerate(jax.tree_util.tree_flatten_with_path(
        canonical_state(states0["decoder"], 2))[0])
        if any(getattr(q, "key", None) == "k" for q in p))
    assert leaf == jleaf
    spec = dict(step=2, cell_id=1, replica=1, leaf=leaf, index=37, bit=22)
    _, want, reports, jexe = jax_static(CFG, "dmr", faults=JFaultSpec.at(**spec))
    out = TS.static_main(TCFG, TS.parser().parse_args(argv("dmr")), states=carried(states0),
                         faults=FaultSpec.at(**spec))
    assert np.array_equal(out["tokens"], want)
    got_ev = float(out["reports"]["decoder"]["events"])
    assert got_ev == float(reports["decoder"]["events"]) and got_ev >= 1
    jm, tm = jexe.metrics(), out["exe"].metrics()
    assert tm["fault_totals"] == jm["fault_totals"] and tm["fault_totals"]["decoder"]["events"]
    assert out["exe"].ledger.recent == jexe.ledger.recent

"""The port's speculating engines on a (2, 4) data x model mesh against
the JAX package's on the same mesh (a child on 8 forced host devices,
``AxisType.Auto`` axes): the paged cases of ``test_torch_spec_sharded``
(true self-speculation and a ``draft_arch`` draft) on the stream of
``test_torch_serving_sharded_paged.SCENARIO``, the port's engines started
from the child's weights (target and draft laid out by ``param_pspecs``).
Tokens, statuses, faults, ledger totals and recent steps and the page
tables must be equal.  ``test_torch_spec_sharded_dense_jax.py`` runs the
dense cases with ``jax_runs``."""

import pickle

import pytest

from repro_torch import bridge
from repro_torch.models.lm_cells import SpecConfig, place_params, resolve_draft_config
from repro_torch.testing import cap_threads_for_xdist
from test_torch_serving_sharded_paged import CFG, mesh_ctx, run
from test_torch_serving_sharded_paged_jax import run_child
from test_torch_spec_sharded import CASES, K, MESH, STRIKE, spec_kw

cap_threads_for_xdist()

FIELDS = ["tokens", "status", "faults", "totals", "recent", "pages"]

_BODY = r"""
out = {}
for case, (serve, spec) in CASES.items():
    eng = engine(**serve, spec=SpecConfig(draft_len=K, **spec))
    with open(os.path.join(os.environ["CHILD_OUT"], case + ".pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, eng._states["weights"]), f)
    out[case] = scenario(eng, miso, Request, leaf_of, host, CFG.vocab_size, STRIKE,
                         spec=SpecConfig(draft_len=K))
print("RESULT" + json.dumps(out))
"""


def jax_runs(cases, tmp) -> dict:
    """``{case: (JAX's run, the port's run from JAX's weights)}`` on the
    mesh, for ``cases`` (names of ``CASES``)."""
    sub = {c: CASES[c] for c in cases}
    got = run_child(_BODY, tmp, MESH=MESH, CASES=sub, K=K, STRIKE=STRIKE)
    out = {}
    for case, (_, spec) in sub.items():
        with open(tmp / f"{case}.pkl", "rb") as f:
            w = pickle.load(f)
        dcfg = resolve_draft_config(CFG, SpecConfig(draft_len=K, **spec))

        def weights(ctx, w=w, dcfg=dcfg):
            st = {"params": place_params(CFG, bridge.states_from_numpy(w["params"], "cpu"), ctx)}
            if "draft" in w:
                st["draft"] = place_params(dcfg, bridge.states_from_numpy(w["draft"], "cpu"), ctx)
            return st

        port = run(mesh_ctx(MESH), STRIKE, req_spec=SpecConfig(draft_len=K), weights=weights,
                   **spec_kw(case))
        out[case] = (got[case], port)
    return out


PAGED_CASES = ("self-paged", "draft-paged")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return jax_runs(PAGED_CASES, tmp_path_factory.mktemp("spec_paged_jax"))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_sharded_paged_speculation_equals_jax_on_the_mesh(pairs, case, field):
    want, got = pairs[case]
    assert got[field] == want[field]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_jax_speculating_engine_ran_the_scenario(pairs, case):
    want, _ = pairs[case]
    assert all(s == "done" for s in want["status"]) and want["request_faults"] == {STRIKE: 1}
    assert want["spec"]["spec_ticks"] > 0 and len(want["pages"]) == 2

"""The bytes member 0 holds of a dry-run cell's arguments
(``launch/dryrun.py::member_bytes`` over the specs) against XLA's
``compiled.memory_analysis().argument_size_in_bytes`` of JAX's dry-run
(``_compile_variant``), in a child on 8 forced host devices with Auto
mesh axes (``test_torch_dryrun_specs.py``'s child), for a reduced train
cell (ZeRO-1 and FSDP) and a decode cell on a (2, 4) mesh: equal to the
byte, but for one named leaf, the trainer's previous metrics (12 bytes),
which no transition reads and which ``jax.jit`` therefore drops from its
arguments (``keep_unused=False``)."""

import pytest

from repro_torch.launch import dryrun as D
from repro_torch.testing import cap_threads_for_xdist
from test_torch_dryrun_specs import case, port, run_children

cap_threads_for_xdist()

ARG_CASES = [case("internlm2-1.8b", "train"), case("internlm2-1.8b", "train", fsdp=True),
             case("internlm2-1.8b", "decode")]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return run_children(tmp_path_factory, [(ARG_CASES, True)])


@pytest.mark.parametrize("c", ARG_CASES, ids=["-".join(map(str, c)) for c in ARG_CASES])
def test_member_argument_bytes_equal_xla(jax_side, c):
    mesh, specs = port(c)
    named = 0
    if c[1] == "train":
        # the one named difference: the previous step's metrics, which no
        # transition reads; jax.jit drops unused arguments (keep_unused=False)
        named = D.member_bytes(specs["trainer"]["metrics"], mesh)
        assert named == 12
    assert D.member_bytes(specs, mesh) - named == jax_side[("arg",) + c]

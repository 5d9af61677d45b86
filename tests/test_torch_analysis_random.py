"""The static analyzer on random programs, against the JAX analyzer:
``tests/test_analysis.py``'s ``_rand_program`` structure (2-6 cells,
declared reads a superset of the consumed ones, so some are dead on
purpose) built in both packages from the same ``random.Random(seed)``.

* 24 seeds: the port's read sets equal JAX's leaf for leaf, every read
  is permitted by ``restrict_reads``, nothing is undeclared, the dead
  reads equal JAX's and the ground truth, the output leaves equal JAX's.
* 30 seeds (``seed + 1000``): MISO002's promise.  Dropping every read the
  analyzer calls dead leaves five ``lockstep`` steps on the CPU bitwise
  identical (unreplicated and with every cell under TMR and a strike);
  the dead reads equal JAX's.  ``chip_smoke.py`` phase 7c replays the
  same programs on the card under DMR and TMR on ``lockstep_cuda``."""

import dataclasses
import random

import pytest
import torch

from repro_torch import api
from repro_torch.analysis import trace_cell
from repro_torch.core import CellType, MisoProgram, RedundancyPolicy
from repro_torch.core.cell import restrict_reads
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves
from test_torch_analysis import jax_analysis  # noqa: F401

cap_threads_for_xdist()


def _rand_transition(name, used, rng):
    coeffs = {d: rng.uniform(0.1, 0.9) for d in used}

    def transition(prev):
        out = prev[name]["x"] * 0.5 + prev[name]["y"].sum()
        for d, c in coeffs.items():
            out = out + c * torch.tanh(prev[d]["x"])
        return {"x": out, "y": prev[name]["y"] * 0.9}

    return transition


def rand_program(seed):
    """``test_analysis._rand_program`` in the port: the same draws of
    ``random.Random(seed)`` in the same order."""
    rng = random.Random(seed)
    n = rng.randint(2, 6)
    names = [f"c{i}" for i in range(n)]
    prog = MisoProgram()
    dead_truth = {}
    for i, name in enumerate(names):
        declared = tuple(m for m in names[:i] if rng.random() < 0.6)
        used = tuple(m for m in declared if rng.random() < 0.6)
        dead_truth[name] = set(declared) - set(used)
        prog.add(CellType(
            name,
            init=lambda g, d: {"x": torch.randn(3, generator=g, device=d),
                               "y": torch.ones(2, device=d)},
            transition=_rand_transition(name, used, rng),
            reads=declared,
        ))
    return prog, dead_truth


@pytest.mark.parametrize("seed", range(24))
def test_read_sets_sound_and_dead_reads_exact(jax_analysis, seed):  # noqa: F811
    from test_analysis import _rand_program

    jprog, jtruth = _rand_program(seed)
    prog, dead_truth = rand_program(seed)
    assert dead_truth == jtruth
    specs, jspecs = prog.state_specs(), jprog.state_specs()
    for name, cell in prog.cells.items():
        access = trace_cell(cell, specs)
        jaccess = jax_analysis.trace_cell(jprog.cells[name], jspecs)
        allowed = restrict_reads(cell, specs)
        for read_cell in access.reads:
            assert read_cell in allowed
        assert not access.undeclared
        assert set(access.dead_reads) == dead_truth[name]
        assert access.to_dict() == jaccess.to_dict()


def _pruned(prog, dead):
    out = MisoProgram()
    for name, cell in prog.cells.items():
        out.add(dataclasses.replace(cell, reads=tuple(r for r in cell.reads if r not in dead[name])))
    return out


def _run(prog, seed, level):
    policies = {c: RedundancyPolicy(level=level) for c in prog.cells} if level > 1 else None
    exe = api.compile(prog, backend="lockstep", device="cpu", policies=policies)
    faults = api.FaultSpec.at(step=2, cell_id=len(prog.cells) - 1, replica=1, index=1, bit=22) \
        if level > 1 else None
    res = exe.run(exe.init(seed), 5, faults=faults)
    return res.states, exe.recoveries, exe.metrics()


@pytest.mark.parametrize("seed", range(30))
def test_deleting_dead_reads_is_bitwise_identical(jax_analysis, seed):  # noqa: F811
    from test_analysis import _rand_program

    prog, _ = rand_program(seed + 1000)
    jprog, _ = _rand_program(seed + 1000)
    specs, jspecs = prog.state_specs(), jprog.state_specs()
    dead = {name: trace_cell(cell, specs).dead_reads for name, cell in prog.cells.items()}
    assert dead == {name: jax_analysis.trace_cell(cell, jspecs).dead_reads
                    for name, cell in jprog.cells.items()}
    pruned = _pruned(prog, dead)
    for level in (1, 3):
        a, rec_a, m_a = _run(prog, seed, level)
        b, rec_b, m_b = _run(pruned, seed, level)
        for la, lb in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert torch.equal(la, lb)
        assert rec_a == rec_b and m_a == m_b

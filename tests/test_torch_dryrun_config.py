"""The dry-run's pure-Python parts against the JAX package's, bit for bit.

For all ten archs at full size: ``segment_counts``, ``with_segment_counts``
(the fields it sets), ``SHAPES``, ``sub_quadratic`` and
``applicable_shapes`` (``models/config.py``).  Then
``launch/analysis.py``: ``analytic_hbm_bytes``, ``model_flops_for`` and
``Roofline`` (given JAX's hardware table) return the same Python floats
as JAX's for every arch x shape x (chips, tp, dp, remat, redundancy) of a
grid, and ``wire_bytes`` (``distributed/wire.py``) gives the per-member
bytes of JAX's ``collective_bytes`` on synthetic HLO lines of each
collective and group size.  Neither side needs a device: JAX's
``launch/analysis.py`` and ``models/config.py`` import no jax."""

import dataclasses
import itertools

import pytest

from repro.configs import get_config as jget
from repro.launch import analysis as JA
from repro.models import config as JC
from repro_torch.configs import CANONICAL
from repro_torch.configs import get_config as tget
from repro_torch.distributed import wire
from repro_torch.launch import analysis as TA
from repro_torch.models import config as TC
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def _moe_dense(cfg):
    return None if cfg.moe is None else cfg.moe.n_dense_layers


@pytest.mark.parametrize("arch", CANONICAL)
def test_config_helpers_equal_jax(arch):
    jc, tc = jget(arch), tget(arch)
    assert TC.segment_counts(tc) == JC.segment_counts(jc)
    assert TC.sub_quadratic(tc) == JC.sub_quadratic(jc)
    assert TC.applicable_shapes(tc) == JC.applicable_shapes(jc)
    base = [1] * len(JC.segment_counts(jc))
    for i in range(len(base) + 1):
        counts = list(base)
        if i < len(base):
            counts[i] = 2
        j, t = JC.with_segment_counts(jc, counts), TC.with_segment_counts(tc, counts)
        assert (t.n_layers, _moe_dense(t)) == (j.n_layers, _moe_dense(j))
        assert TC.segment_counts(t) == JC.segment_counts(j) == counts
        assert t.n_params() == j.n_params() and t.n_active_params() == j.n_active_params()


def test_shapes_equal_jax():
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for name in JC.SHAPES:
        assert dataclasses.astuple(TC.SHAPES[name]) == dataclasses.astuple(JC.SHAPES[name])


GRID = [(256, 8, 32), (512, 8, 64), (16, 4, 4), (8, 1, 8), (512, 16, 16)]
REMATS = ["full", "dots", "none"]


def same_float(a, b):
    return type(a) is type(b) is float and (a == b) and repr(a) == repr(b)


@pytest.mark.parametrize("arch", CANONICAL)
def test_analytic_hbm_bytes_and_model_flops_equal_jax(arch):
    jc, tc = jget(arch), tget(arch)
    assert TA._uses_fsdp(tc) == JA._uses_fsdp(jc)
    for shape_name in JC.SHAPES:
        js, ts = JC.SHAPES[shape_name], TC.SHAPES[shape_name]
        assert same_float(TA.model_flops_for(tc, ts), JA.model_flops_for(jc, js))
        for (chips, tp, dp), remat, red in itertools.product(GRID, REMATS, (1, 2, 3)):
            kw = dict(chips=chips, tp=tp, dp=dp, remat=remat, redundancy=red)
            a, b = TA.analytic_hbm_bytes(tc, ts, **kw), JA.analytic_hbm_bytes(jc, js, **kw)
            assert same_float(a, b), (shape_name, kw)
        for B, S, tp in itertools.product((1, 4, 128), (1, 4096, 524288), (1, 8)):
            assert TA._cache_bytes(tc, B, S, tp) == JA._cache_bytes(jc, B, S, tp)


@pytest.mark.parametrize("terms", [(1.0, 2.0, 3.0), (5e-3, 1e-3, 2e-4), (0.0, 0.0, 0.0),
                                   (2e-2, 2e-2, 1e-9)])
def test_roofline_equals_jax_given_jaxs_table(terms):
    kw = dict(compute_s=terms[0], memory_s=terms[1], collective_s=terms[2],
              flops_per_chip=3.5e13, hbm_bytes_per_chip=1.25e10, wire_bytes_per_chip=7e9,
              model_flops=1.07e16, chips=256)
    j, t = JA.Roofline(**kw), TA.Roofline(**kw, hw=JA.HW)
    assert t.to_dict() == j.to_dict()
    for prop in ("dominant", "bound_s", "useful_ratio", "roofline_fraction"):
        assert getattr(t, prop) == getattr(j, prop), prop
    # the port's own table is the card's, not the TPU's
    assert TA.Roofline(**kw).roofline_fraction != j.roofline_fraction or not j.bound_s
    assert TA.HW["peak_flops"] == 989e12 and TA.HW["hbm_bw"] == 3.35e12


HLO = {
    "all-reduce": "%ar = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %p), replica_groups=[{g},{s}]<=[{t}]",
    "all-gather": "%ag = f32[{n}]{{0}} all-gather(f32[{m}]{{0}} %p), replica_groups=[{g},{s}]<=[{t}]",
    "reduce-scatter": "%rs = f32[{n}]{{0}} reduce-scatter(f32[{m}]{{0}} %p), replica_groups=[{g},{s}]<=[{t}]",
    "all-to-all": "%a2a = f32[{n}]{{0}} all-to-all(f32[{n}]{{0}} %p), replica_groups=[{g},{s}]<=[{t}]",
    "collective-permute": "%cp = f32[{n}]{{0}} collective-permute(f32[{n}]{{0}} %p), source_target_pairs={{{{0,1}}}}",
}


@pytest.mark.parametrize("op", sorted(HLO))
@pytest.mark.parametrize("s", [2, 4, 8, 32])
def test_wire_bytes_equal_collective_bytes(op, s):
    for n in (8, 4096, 3 * 2**20):
        line = HLO[op].format(n=n, m=n // s if n % s == 0 else n, g=256 // s, s=s, t=256)
        got = JA.collective_bytes(line)
        group = s if op != "collective-permute" else 2  # JAX's default group
        assert got["ops"] == 1
        assert wire.wire_bytes(op, 4 * n, group) == got[op] == got["total"]
    assert wire.wire_bytes(op, 1024, 1) == 0.0


def test_serve_config_prefill_len_warms_the_cache_position():
    """``ServeConfig`` has JAX's fields, ``prefill_len`` among them; a
    positive one starts the fixed-batch program's cache there (JAX's
    ``make_serve_program`` does the same), 0 leaves it at 0."""
    import torch

    from repro.models import lm_cells as JL
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm_cells as TL

    assert ([f.name for f in dataclasses.fields(TL.ServeConfig)]
            == [f.name for f in dataclasses.fields(JL.ServeConfig)])
    cfg = get_reduced("internlm2-1.8b")
    for n in (0, 15):
        prog = TL.make_serve_program(cfg, TL.ServeConfig(batch=2, max_len=16, prefill_len=n))
        st = prog.init_states(torch.Generator().manual_seed(0), "cpu")
        pos = st["decoder"]["cache"]["pos"]
        assert pos.dtype == torch.int32 and pos.tolist() == [n, n]

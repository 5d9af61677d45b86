"""The dry-run's cheaper evaluation of a sharded Mamba2 / Zamba2 step held
to the full one.

In the dry-run's counting evaluation (``launch.dryrun.abstract_step``,
whose counters ``core.cell.counting`` registers), ``models.ssm`` runs a
prompt's depthwise convs and scan once for each block shape and counts
each as every member of that shape (``ssm._repeated_members``): the
representative's forward and backward counted ``n`` times, the other
members' outputs and gradients uncounted placeholders made where theirs
would be, which keep what their graphs would keep.  With
``ssm.REPEAT_ON_FAKES`` off every member runs its own.  On reduced
mamba2 and zamba2, train and prefill cells (one layer a segment, as the
dry-run's base variant; 32 tokens x 8 rows) on a (2, 4) mesh, and mamba2
train on (4, 4), the two evaluations' FLOPs, operator bytes, wire bytes
(total, by link and by site) and temp bytes are equal, and the cheaper
one runs the plain scan once a layer and pass, not once a member."""

import pytest

from repro_torch.configs import get_reduced
from repro_torch.core import RedundancyPolicy
from repro_torch.distributed import make_mesh
from repro_torch.kernels import ssd_scan as ks
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import ssm
from repro_torch.models.config import ShapeSpec, segment_counts, with_segment_counts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

KEYS = ("flops", "bytes", "wire", "by_link", "coll", "temp")


def both(arch, kind, shape, monkeypatch) -> dict:
    """{repeat: (counts of one step of the base variant, plain scans
    run)} for the cheaper (True) and the full (False) evaluation."""
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    cfg = get_reduced(arch)
    cfg = with_segment_counts(cfg, [1] * len(segment_counts(cfg)))
    opts = D.arch_opts(arch)
    ctx = make_ctx(mesh, fsdp=opts["fsdp"], vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    scans = []
    plain = ks.ssd_scan_plain
    monkeypatch.setattr(ks, "ssd_scan_plain", lambda *a, **k: scans.append(1) or plain(*a, **k))
    out = {}
    for repeat in (True, False):
        monkeypatch.setattr(ssm, "REPEAT_ON_FAKES", repeat)
        scans.clear()
        run = D._variant(cfg, ShapeSpec("t", kind, 32, 8), mesh, ctx, RedundancyPolicy(),
                         opts["opt"], 1, "none", False)[3]
        out[repeat] = (D.abstract_step(run), len(scans))
    return out


def check(arch, kind, shape, monkeypatch):
    out = both(arch, kind, shape, monkeypatch)
    (cheap, n_cheap), (full, n_full) = out[True], out[False]
    for k in KEYS:
        assert cheap[k] == full[k], (arch, kind, shape, k, cheap[k], full[k])
    members = shape[0] * shape[1]
    assert n_full == members * n_cheap and n_cheap > 0, (n_cheap, n_full)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_mamba2_cheaper_counts_equal_the_full_ones(kind, monkeypatch):
    check("mamba2-2.7b", kind, (2, 4), monkeypatch)


def test_mamba2_train_on_a_larger_mesh(monkeypatch):
    check("mamba2-2.7b", "train", (4, 4), monkeypatch)

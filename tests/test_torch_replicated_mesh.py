"""Replicated (DMR/TMR) state laid out on a mesh (``Sharded`` leaves with a
replica axis), port only.

The §IV primitives on ``Sharded`` leaves give the unsharded results bit
for bit, over random leaves (every dtype the word layer packs) and
random specs on (2, 4) and (2, 2, 2) meshes of CPU devices:
``fingerprint`` (each word weighted by its global position),
``bit_mismatch_elems`` and ``majority_vote`` (each distinct block read
once), ``inject`` (the global element flipped in every member copy that
holds it, the other tensors passed through), and the K4 tie-break's
by-device packing (``kernels.ops.tiebreak_vote``: the plain K4 on the
CPU).  The replicated layout (``replicate_state``, ``stack_replicas``,
``Sharded.__getitem__``) is the JAX dry-run's: the replica entry None
(temporal) or ``"pod"`` (spatial).  Then a DMR trainer on ``host`` on a
(2, 4) FSDP mesh, struck at step 2, repairs the strike and ends bitwise
equal to its unstruck run."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import api as tmiso
from repro_torch.configs import get_reduced as tget
from repro_torch.core import FaultSpec, RedundancyPolicy
from repro_torch.core import redundancy as R
from repro_torch.core.fault import inject
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_map

cap_threads_for_xdist()

MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.bool, torch.int64, torch.uint8,
          torch.float16]


def mesh_of(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def rand_leaf(rng, shape, dtype):
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    bits = torch.from_numpy(rng.integers(0, 256, (*shape, dtype.itemsize)).astype(np.uint8))
    return bits.view(dtype).reshape(shape)


def rand_spec(rng, mesh, shape):
    """A random spec whose axes divide ``shape``: each axis used once."""
    free = list(mesh.axis_names)
    entries = []
    for n in shape:
        pick = [a for a in free if n % mesh.shape[a] == 0 and rng.random() < 0.5]
        if len(pick) > 1 and n % (mesh.shape[pick[0]] * mesh.shape[pick[1]]) == 0 and rng.random() < 0.3:
            entries.append((pick[0], pick[1]))
            free = [a for a in free if a not in pick[:2]]
        elif pick:
            entries.append(pick[0])
            free.remove(pick[0])
        else:
            entries.append(None)
    return S.P(*entries)


def rand_tree(seed, mesh, lead=()):
    """(plain tree, Sharded tree): random leaves, each laid out by a random
    spec (a ``lead`` axis unsharded in front)."""
    rng = np.random.default_rng(seed)
    plain, sharded = {}, {}
    for i, dtype in enumerate(DTYPES + DTYPES[:3]):
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8])) for _ in range(int(rng.integers(0, 4))))
        x = rand_leaf(rng, lead + shape, dtype)
        spec = S.P(*([None] * len(lead)), *rand_spec(rng, mesh, shape))
        plain[f"l{i}"] = x
        sharded[f"l{i}"] = S.shard_leaf(x, spec, mesh)
    return plain, sharded


def ints(x):
    return x.to(torch.uint8) if x.dtype == torch.bool else x.view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])


def same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(ints(x), ints(y))
        for x, y in zip(la, lb))


def full(tree):
    return S.unshard(tree)


CASES = list(itertools.product(sorted(MESHES), range(4)))


@pytest.mark.parametrize("mesh_name,seed", CASES)
def test_fingerprint_of_a_sharded_state_is_its_unsharded_fingerprint(mesh_name, seed):
    mesh = mesh_of(mesh_name)
    plain, sharded = rand_tree(seed, mesh)
    assert torch.equal(R.fingerprint(sharded), R.fingerprint(plain))
    plain3, sharded3 = rand_tree(seed + 50, mesh, lead=(3,))
    assert torch.equal(R.fingerprint_rows(sharded3, 3), R.fingerprint_rows(plain3, 3))


@pytest.mark.parametrize("mesh_name,seed", CASES)
def test_mismatch_vote_and_inject_on_sharded_leaves(mesh_name, seed):
    mesh = mesh_of(mesh_name)
    rng = np.random.default_rng(seed + 100)
    a, sa = rand_tree(seed, mesh)
    b = tree_map(lambda x: x.clone(), a)
    c = tree_map(lambda x: x.clone(), a)
    # two strikes in b, one in c, at random elements
    for tree, n in ((b, 2), (c, 1)):
        for _ in range(n):
            k = f"l{int(rng.integers(len(tree)))}"
            if tree[k].numel():
                idx = int(rng.integers(tree[k].numel()))
                flat = ints(tree[k]).reshape(-1)
                flat[idx] = flat[idx] ^ 1
    lay = lambda t: {k: S.shard_leaf(t[k], sa[k].spec, mesh) for k in t}
    sb, sc = lay(b), lay(c)
    assert torch.equal(R.bit_mismatch_elems(sa, sb), R.bit_mismatch_elems(a, b))
    assert torch.equal(R.bit_mismatch_elems(sb, sc), R.bit_mismatch_elems(b, c))
    voted = R.majority_vote(sa, sb, sc)
    assert all(isinstance(x, S.Sharded) for x in tree_leaves(voted))
    assert same(full(voted), R.majority_vote(a, b, c))
    # inject on the replicated layout: the global element of replica 1
    rep, srep = R.replicate_state(a, 2), R.replicate_state(sa, 2)
    for leaf in range(len(a)):
        n = tree_leaves(a)[leaf].numel()
        f = FaultSpec.at(step=3, cell_id=0, replica=1, leaf=leaf,
                         index=int(rng.integers(max(n, 1))), bit=int(rng.integers(64)))
        got = inject(f, cell_id=0, step=3, replicated_state=srep)
        assert same(full(got), inject(f, cell_id=0, step=3, replicated_state=rep))
        # only the tensors that hold the element were copied
        x, y = tree_leaves(srep)[leaf], tree_leaves(got)[leaf]
        moved = {id(y.local(c)) for c in y.coords()} - {id(x.local(c)) for c in x.coords()}
        held = {S._key(x.block(c)) for c in x.coords() if id(y.local(c)) != id(x.local(c))}
        assert len(held) <= 1 and len(moved) <= len(x.distinct())


@pytest.mark.parametrize("mesh_name,seed", CASES[::2])
def test_tiebreak_votes_each_device_distinct_blocks(mesh_name, seed):
    """The K4 tie-break's Sharded path: replicas packed and released before
    the third transition runs, the vote bitwise ``majority_vote``'s."""
    mesh = mesh_of(mesh_name)
    a, sa = rand_tree(seed, mesh)
    b = tree_map(lambda x: x.clone(), a)
    k = "l0"
    ints(b[k]).reshape(-1)[0] ^= 4
    lay = lambda t: {n: S.shard_leaf(t[n], sa[n].spec, mesh) for n in t}
    pair = R.stack_replicas([tree_leaves(lay(a)), tree_leaves(lay(b))])
    from repro_torch.tree import tree_flatten, tree_unflatten
    td = tree_flatten(a)[1]
    box = [tree_unflatten(td, pair)]
    del pair
    seen = {}

    def third():
        seen["released"] = not box
        return lay(a)

    voted, counts = ops.tiebreak_vote(box, third)
    assert seen["released"] and same(full(voted), a)
    assert [int(x) for x in counts] == [0, 1 if a[k].numel() else 0, 0]
    assert all(isinstance(x, S.Sharded) for x in tree_leaves(voted))


def test_the_replicated_layout_is_the_dry_runs():
    mesh = mesh_of("2x2x2")
    x = torch.arange(64.0).reshape(8, 8)
    sx = S.shard_leaf(x, S.P(None, "model"), mesh)
    t = R.replicate_state({"w": sx}, 2)["w"]
    assert tuple(t.spec) == (None, None, "model") and tuple(t.shape) == (2, 8, 8)
    sp = R.replicate_state({"w": sx}, 2, "spatial")["w"]
    assert tuple(sp.spec) == ("pod", None, "model")
    # pod p's members hold replica p's blocks, one copy a pod
    assert all(sp.local(c).shape == (1, 8, 4) for c in sp.coords())
    assert len({id(sp.local(c)) for c in sp.coords()}) == 4
    assert all(sp.local(c).data_ptr() != sx.local(c).data_ptr() for c in sp.coords())
    for r in range(2):
        v = sp[r]
        assert tuple(v.spec) == (None, "model") and torch.equal(v.full(), x)
        assert all(v.local(c).data_ptr() == sp.local((r,) + c[1:]).data_ptr() for c in v.coords())
    assert torch.equal(R.canonical_state({"w": sp}, 2)["w"].full(), x)
    with pytest.raises(ValueError, match="pod"):
        R.replicate_state({"w": sx}, 3, "spatial")
    with pytest.raises(ValueError, match="pod"):
        R.replicate_state({"w": S.shard_leaf(x, S.P(None, "model"), mesh_of("2x4"))}, 2, "spatial")


def trainer_run(strike: bool, steps: int = 4):
    cfg = dataclasses.replace(tget("internlm2-1.8b"), dtype="float32")
    mesh = mesh_of("2x4")
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=True)
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=32, vocab=cfg.vocab_size),
                          opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    prog = TL.make_train_program(cfg, tcfg, ctx).with_policies(
        {"trainer": RedundancyPolicy(level=2)})
    exe = tmiso.compile(prog, backend="host", device="cpu")
    faults = [FaultSpec.at(step=2, cell_id=1, replica=1, leaf=5, index=7, bit=21)] if strike else []
    res = exe.run(exe.init(0), steps, faults=faults)
    return exe, res


def test_dmr_host_trainer_on_a_mesh_repairs_a_strike_bitwise():
    exe, res = trainer_run(True)
    clean_exe, clean = trainer_run(False)
    assert exe.recoveries == [(2, "trainer")] and clean_exe.recoveries == []
    tot = exe.metrics()["fault_totals"]["trainer"]
    assert tot["events"] == 1.0 and clean_exe.metrics()["fault_totals"]["trainer"]["events"] == 0
    tr, ctr = res.states["trainer"], clean.states["trainer"]
    assert all(isinstance(x, S.Sharded) for x in tree_leaves(tr["params"]))
    assert tuple(tr["params"]["embed"].spec)[0] is None
    assert same(full(tr), full(ctr))
    assert torch.equal(R.fingerprint(tr), R.fingerprint(full(tr)))


def test_lockstep_cuda_refuses_a_replicated_state_on_a_mesh():
    cfg = dataclasses.replace(tget("internlm2-1.8b"), dtype="float32", n_layers=1)
    mesh = mesh_of("2x4")
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=16, vocab=cfg.vocab_size))
    prog = TL.make_train_program(cfg, tcfg, ctx).with_policies(
        {"trainer": RedundancyPolicy(level=2)})
    exe = tmiso.compile(prog, backend="lockstep_cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="lockstep_pallas"):
        exe.step(exe.init(0))


def test_an_unreplicated_sharded_leaf_is_strikeable():
    """A level-1 cell's struck ``Sharded`` leaf takes the flip at its global
    element in every member copy, undetected, as a plain leaf does."""
    from repro_torch.core import CellType, MisoProgram

    mesh = mesh_of("2x4")
    x = torch.arange(32.0).reshape(4, 8)
    cell = CellType(name="c", init=lambda g, d: {"w": S.shard_leaf(x, S.P("data", None), mesh)},
                    transition=lambda prev: {"w": prev["c"]["w"].map(lambda t: t + 1)})
    exe = tmiso.compile(MisoProgram().add(cell), backend="lockstep", device="cpu")
    f = FaultSpec.at(step=0, cell_id=0, leaf=0, index=13, bit=3)
    st, _ = exe.step(exe.init(0), fault=f)
    want = (x + 1).clone()
    ints(want).reshape(-1)[13] ^= 8
    assert isinstance(st["c"]["w"], S.Sharded) and same(st["c"]["w"].full(), want)

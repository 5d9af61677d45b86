"""``SlotManager(n, pods=...)`` against the JAX package's, in process
(the manager is host code, no device).  Random sequences of alloc
(unreplicated, contiguous, spatial), release and defrag (``defrag_plan``
followed by the ``relocate`` calls the engine makes), plus ``find_run``
and ``find_column`` probes, must give the same answers and leave the
same free list, ownership and pinned set after every operation."""

import numpy as np
import pytest

from repro.serving.slots import SlotManager as JSlotManager
from repro_torch.serving.slots import SlotManager
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

LAYOUTS = [(8, 1), (8, 2), (9, 3), (12, 4), (6, 3), (12, 3)]


def snapshot(m) -> tuple:
    return (sorted(m._free), {k: list(v) for k, v in m._slots_of.items()}, dict(m._owner),
            sorted(m._pinned), m.free, m.active)


def run_sequence(seed: int, n_slots: int, pods: int, steps: int = 60) -> int:
    rng = np.random.default_rng(seed)
    ours, ref = SlotManager(n_slots, pods=pods), JSlotManager(n_slots, pods=pods)
    assert ours.per_pod == ref.per_pod
    live, next_id, checked = [], 0, 0
    for _ in range(steps):
        op = rng.choice(["alloc", "alloc", "release", "defrag", "probe"])
        if op == "alloc":
            n = int(rng.integers(1, 4))
            contiguous, spatial = bool(rng.integers(2)), bool(rng.integers(2))
            rid = f"r{next_id}"
            next_id += 1
            got = ours.alloc(rid, n, contiguous=contiguous, spatial=spatial)
            want = ref.alloc(rid, n, contiguous=contiguous, spatial=spatial)
            assert got == want, (seed, rid, n, contiguous, spatial)
            if got is not None:
                live.append(rid)
        elif op == "release" and live:
            rid = live.pop(int(rng.integers(len(live))))
            assert ours.release(rid) == ref.release(rid)
        elif op == "defrag":
            n = int(rng.integers(1, 4))
            plan = ours.defrag_plan(n)
            assert plan == ref.defrag_plan(n), (seed, n)
            for src, dst in plan or ():
                assert ours.relocate(src, dst) == ref.relocate(src, dst)
        else:
            n = int(rng.integers(1, 4))
            assert ours.find_run(n) == ref.find_run(n)
            assert ours.find_column(n) == ref.find_column(n)
            for s in range(n_slots):
                assert ours.owner(s) == ref.owner(s)
        assert snapshot(ours) == snapshot(ref), (seed, op)
        checked += 1
    return checked


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{n}x{p}" for n, p in LAYOUTS])
@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_equal_jax(layout, seed):
    assert run_sequence(seed, *layout) == 60


def test_spatial_groups_take_one_column_and_stay_pinned():
    m = SlotManager(9, pods=3)
    assert m.alloc("t", 3, spatial=True) == [0, 3, 6]  # replica i on pod i
    assert m.alloc("d", 2, spatial=True) == [1, 4]
    assert m.alloc("u", 1) == [8]  # unreplicated fills from the highest pod
    # slot 8 is pod 2's column 2: a TMR group no longer fits, a DMR one does
    assert m.find_column(3) is None and m.find_column(2) == 2
    assert m.alloc("x", 4, spatial=True) is None
    plan = m.defrag_plan(2)
    pinned = {0, 3, 6, 1, 4}
    assert plan is None or not any(s in pinned for pair in plan for s in pair)
    m.release("t")
    assert m.find_column(3) == 0 and not (m._pinned & {0, 3, 6})
    with pytest.raises(ValueError, match="multiple of"):
        SlotManager(8, pods=3)
    with pytest.raises(ValueError, match="already holds"):
        m.alloc("d", 1)

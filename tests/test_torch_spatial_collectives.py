"""The port's mesh and cross-pod collectives (``repro_torch.distributed``)
against the JAX package's.

JAX's collectives are ``shard_map`` bodies over a mesh axis, and jax pins
its device count at first init, so they run in a subprocess with 8
forced host devices (the pattern of ``tests/test_spatial.py``) on inputs
made there from a seed with numpy; the child saves inputs and outputs
(bf16 as its uint16 bits) and the port's collectives, given the same
per-member values on ``["cpu"] * n`` meshes, must return the same bits:
``psum_delta`` (2 and 3 members), ``bcast_pytree`` (a traced and a
static non-zero source, -0.0 and NaN payloads), ``exchange_pytree``,
``gather_replicas`` (f32, bf16, bool and i64 leaves) and ``psum_mean``;
``compressed_psum_int8`` over 3 steps of error feedback within 1e-6
(atol = rtol).  Then the mesh itself: ``make_mesh`` refuses to invent
devices, takes repeated ones when asked, and ``make_production_mesh``
leads with the pod axis."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed import Mesh, make_mesh
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed import collectives as C

out = {}
rng = np.random.default_rng(0)


def save(prefix, tree):
    for k, v in tree.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            out[f"{prefix}/{k}__bf16"] = v.view(np.uint16)
        else:
            out[f"{prefix}/{k}"] = v


def on_pods(n, body, *args):
    mesh = jax.make_mesh((n,), ("pod",))
    f = shard_map(lambda *a: body(*[jax.tree.map(lambda x: x[0], t) for t in a]),
                  mesh=mesh, in_specs=tuple(P("pod") for _ in args), out_specs=P("pod"),
                  check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(f)(*args))


def expand(body):
    # a member's result with a leading axis of 1, as out_specs P("pod") stacks
    return lambda *a: jax.tree.map(lambda x: x[None], body(*a))


def tree(n):
    f = rng.standard_normal((n, 5, 3)).astype(np.float32)
    f[:, 0, 0] = -0.0
    f[:, 1, 1] = np.frombuffer(np.uint32(0x7FC01234).tobytes(), np.float32)[0]  # NaN payload
    return {
        "f32": f,
        "bf16": jnp.asarray(rng.standard_normal((n, 7)), jnp.bfloat16),
        "bool": rng.integers(0, 2, (n, 3, 3)).astype(bool),
        "i64": rng.integers(-2**62, 2**62, (n, 4), dtype=np.int64),
    }


for n in (2, 3):
    h = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
    if n == 2:
        h[1, 2] = h[0, 2]  # one word equal
    save(f"psum_delta{n}", {"in": h, "out": on_pods(n, expand(lambda x: C.psum_delta(x, "pod")), h)})

t3 = tree(3)
save("bcast/in", t3)
src = np.full((3,), 2, np.int32)
save("bcast/traced", on_pods(3, expand(lambda t, s: C.bcast_pytree(t, "pod", s)), t3, src))
save("bcast/static", on_pods(3, expand(lambda t: C.bcast_pytree(t, "pod", 1)), t3))
t2 = tree(2)
save("exchange/in", t2)
save("exchange/out", on_pods(2, expand(lambda t: C.exchange_pytree(t, "pod")), t2))
save("gather/in", t3)
save("gather/out", on_pods(3, expand(lambda t: C.gather_replicas(t, "pod")), t3))

x = rng.standard_normal((4, 1000)).astype(np.float32)
save("mean", {"in": x, "out": on_pods(4, expand(lambda v: C.psum_mean(v, "pod")), x)})

g = rng.standard_normal((4, 4 * 512 * 2)).astype(np.float32)
ef = np.zeros_like(g)
save("int8", {"in": g})
for step in range(3):
    gs = g * (1.0 + step)
    mean, ef = on_pods(4, expand(lambda a, e: C.compressed_psum_int8(a, e, "pod")), gs, ef)
    save(f"int8/{step}", {"mean": mean, "ef": ef})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_collectives(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    raw = np.load(path)
    out = {}
    for key in raw.files:
        a = raw[key]
        if key.endswith("__bf16"):
            out[key[: -len("__bf16")]] = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(a.copy())
    return out


def members(d: dict, prefix: str) -> list:
    """The per-member trees of ``prefix``'s stacked leaves."""
    keys = sorted(k for k in d if k.startswith(prefix + "/") and k.count("/") == prefix.count("/") + 1)
    n = d[keys[0]].shape[0]
    return [{k.rsplit("/", 1)[1]: d[k][p] for k in keys} for p in range(n)]


def bits(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.core.fault import bitcast_int

    return bitcast_int(x)


def same_bits(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def u32_in_i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [2, 3])
def test_psum_delta_bitwise(jax_collectives, n):
    d = jax_collectives
    h = u32_in_i64(d[f"psum_delta{n}/in"].view(torch.int32))
    got = C.psum_delta([h[p] for p in range(n)])
    want = u32_in_i64(d[f"psum_delta{n}/out"].view(torch.int32))
    assert all(torch.equal(g, want[p]) for p, g in enumerate(got))
    if n == 2:  # zero exactly where the two members' words agree
        assert [int(w) for w in got[0]].count(0) == 1 and int(got[0][2]) == 0


@pytest.mark.parametrize("src", ["traced", "static"])
def test_bcast_pytree_bitwise(jax_collectives, src):
    d = jax_collectives
    ins = members(d, "bcast/in")
    got = C.bcast_pytree(ins, torch.tensor(2, dtype=torch.int32) if src == "traced" else 1)
    want = members(d, f"bcast/{src}")
    assert all(same_bits(g, w) for g, w in zip(got, want))
    assert all(same_bits(g, ins[2 if src == "traced" else 1]) for g in got)
    # -0.0 and the NaN payload travel as bits
    f = got[0]["f32"]
    assert torch.signbit(f[0, 0]) and f[1, 1].view(torch.int32) == 0x7FC01234
    assert len({g["f32"].data_ptr() for g in got}) == 3  # each member its own copy


def test_exchange_pytree_bitwise(jax_collectives):
    d = jax_collectives
    ins = members(d, "exchange/in")
    got = C.exchange_pytree(ins)
    want = members(d, "exchange/out")
    assert all(same_bits(g, w) for g, w in zip(got, want))
    assert same_bits(got[0], ins[1]) and same_bits(got[1], ins[0])
    with pytest.raises(ValueError, match="pair"):
        C.exchange_pytree(ins + ins[:1])


def test_gather_replicas_bitwise(jax_collectives):
    d = jax_collectives
    ins = members(d, "gather/in")
    got = C.gather_replicas(ins)
    want = members(d, "gather/out")
    assert {x.dtype for x in tree_leaves(ins[0])} == {torch.float32, torch.bfloat16, torch.bool,
                                                      torch.int64}
    assert all(same_bits(g, w) for g, w in zip(got, want))
    assert got[0]["i64"].shape == (3, 4)


def test_psum_mean_bitwise(jax_collectives):
    d = jax_collectives
    x = d["mean/in"]
    got = C.psum_mean([x[p] for p in range(4)])
    assert all(torch.equal(g, d["mean/out"][p]) for p, g in enumerate(got))


def test_compressed_psum_int8_with_error_feedback(jax_collectives):
    d = jax_collectives
    g = d["int8/in"]
    ef = [torch.zeros_like(g[p]) for p in range(4)]
    for step in range(3):
        gs = g * (1.0 + step)
        out = C.compressed_psum_int8([gs[p] for p in range(4)], ef)
        for p, (mean, new_ef) in enumerate(out):
            torch.testing.assert_close(mean, d[f"int8/{step}/mean"][p], atol=1e-6, rtol=1e-6)
            torch.testing.assert_close(new_ef, d[f"int8/{step}/ef"][p], atol=1e-6, rtol=1e-6)
        ef = [e for _, e in out]
    with pytest.raises(ValueError, match="multiple"):
        C.compressed_psum_int8([torch.zeros(100)] * 2, [torch.zeros(100)] * 2)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
def test_make_mesh_refuses_to_invent_devices():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("64 cards present")
    with pytest.raises(ValueError, match="pass devices= explicitly"):
        make_mesh((64,), ("pod",))
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh((3,), ("pod",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("pod",), devices=["cpu"] * 4)


def test_mesh_of_repeated_devices():
    mesh = make_mesh((2, 4, 1), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert mesh.shape == {"pod": 2, "data": 4, "model": 1}
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.devices.shape == (2, 4, 1)
    assert mesh.pod_device(1) == torch.device("cpu") and mesh.home() == torch.device("cpu")
    assert mesh.pod_stream(0) is None
    with mesh.on_pod(1, reads={"x": torch.ones(2)}):
        pass  # on the CPU nothing to order
    assert mesh.collect(1, {"x": 1}) == {"x": 1}
    nested = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("pod", "data"))
    assert nested.shape == {"pod": 2, "data": 2}
    with pytest.raises(ValueError, match="rank"):
        Mesh(["cpu", "cpu"], ("pod", "data"))


def test_production_mesh_leads_with_the_pod_axis():
    mesh = make_production_mesh(multi_pod=True, devices=["cpu"] * 4)
    assert mesh.axis_names == ("pod", "data", "model") and mesh.shape["pod"] == 2
    assert make_production_mesh(devices=["cpu"] * 3).axis_names == ("data", "model")
    with pytest.raises(ValueError, match="even"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            make_production_mesh()

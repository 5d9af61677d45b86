"""The trainer on a device mesh (``make_train_program(cfg, tcfg, ctx)``)
against the JAX package's trainer on one.

JAX's side runs in a child process on 8 forced host devices with a
(2, 4) data x model mesh whose axes are ``AxisType.Auto`` (as
``tests/test_torch_decode_spmd.py``'s child: under the installed jax,
``make_mesh`` alone gives Explicit axes).  The child builds the train
program under ``make_ctx(mesh, fsdp=...)``, runs it on ``lockstep`` and
returns the initial states and each step's metrics and states.  The
port starts from the same initial states (``repro_torch.bridge``), lays
the trainer state out as the JAX dry-run does
(``lm_cells.place_train_state``: params by ``param_pspecs``, the
optimizer state by ``zero_pspecs``) on a (2, 4) mesh of CPU devices and
runs the same steps on the ``host`` back-end, sharded and unsharded.

Cases (reduced internlm2 in f32, lr 5e-3 then 1e-2): ZeRO-1 (``fsdp``
off), FSDP (``fsdp`` on), and FSDP with 8-bit moments and no f32 master
(``OptConfig(quantized_state=True, master_fp32=False)``, ``d_ff`` 256 so
that the MLP's moments quantize and a model member's slice of their
last axis is a quarter of a 256-element block).  Gates, against JAX's
run and against the port's unsharded run: loss and grad_norm of both
steps within 1e-5; the batches bitwise; and each step taken from the
same input state (JAX's: its initial state, then its state after step
1) held leaf by leaf (``check_step``): every moment leaf within 1e-5 in
L2 against its own norm, and every param and master leaf's update
(new - input) within 1e-5 of its norm over the elements whose new second
moment is at least ``WELL`` of the leaf's largest; each other element
within 2 lr.  Why not the whole update: AdamW's first update is
``lr * g / |g|``, so an element whose grad is near 0 moves by up to 2 lr
on the last bits of its grad (another summation order).  A quantized
moment is held by its int8 codes: every code within one of the other
run's (a value within float noise of a rounding tie rounds either way)
and its scales within 1e-5; an element whose 8-bit second moment came in
as 0 with a non-zero first moment has no bound on its update (the step
divides its first moment by its own g^2 alone, which a last-bit
difference of a near-0 grad moves by any amount).  The chained runs'
state after step 2 is held too, every float leaf joined within 1e-5
(``check_state``): a step's differences of 2 lr on a few elements reach
every later grad, and the port's *unsharded* trainer is 1.3e-5 from
JAX's FSDP run on a LayerNorm's second moment after two chained steps,
as the sharded one is.
The quantized case runs these tests in ``test_torch_train_spmd_quant.py``
(one JAX child a file stays near 30 s); ``test_torch_train_int8ef.py``
(``int8_ef``) and ``test_torch_elastic_mesh.py`` (restore onto a new
mesh) share the helpers here."""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import Sharded, unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig, _dequantize
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_paths

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
BATCH, SEQ = 8, 32
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)

#: case -> (config overrides, fsdp, OptConfig kwargs, grad_compression, steps)
CASES = {
    "zero1": ({}, False, {}, "none", 2),
    "fsdp": ({}, True, {}, "none", 2),
    "quantized": ({"d_ff": 256}, True, {"quantized_state": True, "master_fp32": False}, "none", 2),
    "int8_ef": ({}, False, {}, "int8_ef", 3),
}

#: the JAX children's XLA: 8 host devices, each device's work on its own
#: thread (no Eigen pool beside the 8 under the suite's parallel run) and
#: the collectives' rendezvous given minutes, not XLA's 20 s warning and
#: 40 s end, when the host is loaded (a child's numbers do not change)
CHILD_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false "
                   "--xla_cpu_collective_call_warn_stuck_timeout_seconds=120 "
                   "--xla_cpu_collective_call_terminate_timeout_seconds=600 "
                   "--xla_cpu_collective_timeout_seconds=600")

_CHILD = r"""
import os, sys, pickle, functools
os.environ["XLA_FLAGS"] = "@XLA_FLAGS@"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType

from repro import api as miso
from repro.configs import get_reduced
from repro.data.pipeline import DataConfig
from repro.launch.mesh import make_ctx
from repro.models import lm_cells as L
from repro.models import transformer as T
from repro.optim.adamw import OptConfig

arch, over, fsdp, optkw, comp, steps, batch, seq, opt_base, out, local, sp, jit_init = \
    pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **over)
ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=fsdp,
               seq_shard_acts=sp)
tcfg = L.TrainConfig(data=DataConfig(batch=batch, seq_len=seq, vocab=cfg.vocab_size),
                     opt=OptConfig(**opt_base, **optkw), grad_compression=comp)
prog = L.make_train_program(cfg, tcfg, ctx)
exe = miso.compile(prog, backend="lockstep")
st = jax.jit(prog.init_states)(jax.random.PRNGKey(0)) if jit_init else prog.init_states(
    jax.random.PRNGKey(0))
res = {"init": jax.tree.map(np.asarray, st), "metrics": [], "states": [], "data_tokens": [],
       "data": [], "means": [], "efs": []}
if comp == "int8_ef":
    loss = functools.partial(T.loss_fn, cfg,
                             ctx=dataclasses.replace(ctx, manual_axes=tuple(ctx.data_axes)))

    def gfn(params, b):
        (_, m), g = jax.value_and_grad(loss, has_aux=True)(params, b)
        return g, m

    @jax.jit
    def mean_fn(params, tokens, ef):
        grads, _, new_ef = L._compressed_grads(gfn, params, {"tokens": tokens}, ef, ctx)
        return jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(grads)]), new_ef

    member_grads = jax.jit(lambda params, tokens: gfn(params, {"tokens": tokens})[0])

    def recorded(params, b):
        # the data member's own slice of the grads handed in with its rows
        return jax.tree.map(lambda g: g[0], b["g"]), {"loss": jnp.zeros((), jnp.float32)}

    @jax.jit
    def forced_fn(params, tokens, g, ef):
        grads, _, new_ef = L._compressed_grads(recorded, params, {"tokens": tokens, "g": g},
                                               ef, ctx)
        return jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(grads)]), new_ef

    def per_member(x):
        # each data member's own buffer, from its devices' shards
        bufs = []
        for d in range(2):
            buf = np.zeros(x.shape, np.float32)
            for sh in x.addressable_shards:
                if sh.device in list(mesh.devices[d]):
                    buf[sh.index] = np.asarray(sh.data)
            bufs.append(buf)
        return bufs

with mesh:
    for _ in range(steps):
        if comp == "int8_ef":
            tr, toks = st["trainer"], st["data"]["tokens"]
            mean, new_ef = mean_fn(tr["params"], toks, tr["ef"])
            rows = toks.shape[0] // 2
            grads = [member_grads(tr["params"], toks[d * rows:(d + 1) * rows]) for d in range(2)]
            fmean, fef = forced_fn(tr["params"], toks,
                                   jax.tree.map(lambda a, b: jnp.stack([a, b]), *grads), tr["ef"])
            res["means"].append(dict(
                mean=np.asarray(mean), ef_in=per_member(tr["ef"]), ef_out=per_member(new_ef),
                forced_mean=np.asarray(fmean), forced_ef=per_member(fef),
                grads=[jax.tree.map(np.asarray, g) for g in grads]))
        # the executor donates its input: hand it copies (an f32 master
        # is the params' own buffer)
        st = exe.run(jax.tree.map(jnp.copy, st), 1).states
        res["metrics"].append(jax.tree.map(np.asarray, st["trainer"]["metrics"]))
        res["states"].append(jax.tree.map(np.asarray, st["trainer"]))
        res["data_tokens"].append(np.asarray(st["data"]["tokens"]))
        res["data"].append(jax.tree.map(np.asarray, st["data"]))
        if comp == "int8_ef":
            res["efs"].append(np.asarray(st["trainer"]["ef"]))  # the host view
res["final"] = jax.tree.map(np.asarray, st)
if local:
    # the unsharded trainer, one step from each of the mesh run's inputs
    lexe = miso.compile(L.make_train_program(cfg, tcfg), backend="lockstep")
    ins = [res["init"]] + [{"trainer": t, "data": d} for t, d in zip(res["states"], res["data"])]
    res["local_stepped"] = [
        jax.tree.map(np.asarray, lexe.run(jax.tree.map(jnp.array, s), 1).states["trainer"])
        for s in ins[:steps]]
with open(out, "wb") as f:
    pickle.dump(res, f)
""".replace("@XLA_FLAGS@", CHILD_XLA_FLAGS)


def run_child(case, tmp_path_factory, arch=ARCH, local=False, seq_shard_acts=False,
              jit_init=None) -> dict:
    """JAX's mesh run of ``case`` on ``arch``; with ``local`` JAX's
    unsharded trainer one step from each of its inputs (``local_stepped``)
    and, unless ``jit_init`` says otherwise, its initial state made under
    ``jax.jit`` (an eager init of the mesh program takes 15 s);
    ``seq_shard_acts`` goes into JAX's ``make_ctx``."""
    over, fsdp, optkw, comp, steps = CASES[case]
    out = tmp_path_factory.mktemp(case) / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    arg = pickle.dumps((arch, over, fsdp, optkw, comp, steps, BATCH, SEQ, OPT, str(out),
                        local, seq_shard_acts, local if jit_init is None else jit_init)).hex()
    proc = subprocess.run([sys.executable, "-c", _CHILD, arg], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def port_setup(case, shape=(2, 4), arch=ARCH, seq_shard_acts=False):
    """(cfg, tcfg, ctx) of a case on a mesh of ``shape`` CPU devices."""
    over, fsdp, optkw, comp, _ = CASES[case]
    cfg = dataclasses.replace(tget(arch), dtype="float32", **over)
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=fsdp,
                   seq_shard_acts=seq_shard_acts)
    tcfg = TL.TrainConfig(data=DataConfig(batch=BATCH, seq_len=SEQ, vocab=cfg.vocab_size),
                          opt=OptConfig(**OPT, **optkw), grad_compression=comp)
    return cfg, tcfg, ctx


def placed(cfg, ctx, init) -> dict:
    """JAX's initial states, carried over and laid out on ``ctx``'s mesh."""
    st = bridge.states_from_numpy(init, device="cpu")
    st["trainer"] = TL.place_train_state(cfg, ctx, st["trainer"])
    return st


def jax_input(jax_res, step) -> dict:
    """JAX's states before ``step`` (numpy trees)."""
    if step == 0:
        return jax_res["init"]
    return {"trainer": jax_res["states"][step - 1], "data": jax_res["data"][step - 1]}


def port_run(case, jax_res, arch=ARCH, seq_shard_acts=False, unsharded=True) -> dict:
    """The port's steps from JAX's initial states, sharded and (with
    ``unsharded``, but for ``int8_ef``, which needs the mesh) unsharded:
    chained (``states``), and each step taken from JAX's state before it
    (``stepped``)."""
    cfg, tcfg, ctx = port_setup(case, arch=arch, seq_shard_acts=seq_shard_acts)
    steps = CASES[case][4]
    out = {}
    for label, c in (("sharded", ctx), ("unsharded", None)):
        if c is None and (tcfg.grad_compression != "none" or not unsharded):
            continue
        prog = TL.make_train_program(cfg, tcfg, c) if c is not None else TL.make_train_program(cfg, tcfg)
        exe = tmiso.compile(prog, backend="host", device="cpu")

        def start(step):
            src = jax_input(jax_res, step)
            return placed(cfg, c, src) if c is not None else bridge.states_from_numpy(src, device="cpu")

        st = start(0)
        metrics, batches, states = [], [], []
        for _ in range(steps):
            batches.append(st["data"]["tokens"])
            st = exe.run(st, 1).states
            metrics.append(st["trainer"]["metrics"])
            states.append(st["trainer"])
        stepped = states[:1] + [exe.run(start(t), 1).states["trainer"] for t in range(1, steps)]
        out[label] = {"metrics": metrics, "final": st, "batches": batches, "states": states,
                      "stepped": stepped}
    return out


def close(a, b, rel, what):
    """``b`` within ``rel`` of ``a`` in L2, relative to ``a``'s norm (a
    scalar: its magnitude)."""
    a = np.asarray(a, np.float64)
    b = b.detach().double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err, scale = float(np.linalg.norm(a - b)), max(float(np.linalg.norm(a)), 1e-30)
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


def moment_leaves(tree, path=()) -> list:
    """(path, leaf) of a params or moments tree, a quantized
    ``{"q", "scale"}`` moment one leaf."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in moment_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in moment_leaves(t, path + (i,))]
    return [(path, tree)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trainer_leaves(tr) -> list:
    """(name, leaf) of every param, moment and master leaf of a trainer
    state (a ``Sharded`` one unsharded)."""
    tr = unshard(tr)
    out = [(("params",) + p, x) for p, x in moment_leaves(tr["params"])]
    for key in ("m", "v", "master"):
        if key in tr["opt"]:
            out += [((key,) + p, x) for p, x in moment_leaves(tr["opt"][key])]
    return out


def _q_close(a, b, rel, what):
    """Two int8 moments: codes within one, scales within ``rel``."""
    qa, qb = _np(a["q"]).astype(np.int64), _np(b["q"]).astype(np.int64)
    assert np.abs(qa - qb).max() <= 1, f"{what} codes"
    close(_np(a["scale"]), b["scale"], rel, f"{what} scale")


def check_state(want, got, rel, what):
    """The chained runs' trainer state ``got`` against ``want``: every
    float leaf joined within ``rel``, an int8 moment by ``_q_close``, the
    step bitwise."""
    joined = [[], []]
    for (path, a), (_, b) in zip(trainer_leaves(want), trainer_leaves(got)):
        if isinstance(a, dict):
            _q_close(a, b, rel, f"{what} {path}")
        else:
            joined[0].append(_np(a).astype(np.float64).ravel())
            joined[1].append(_np(b).astype(np.float64).ravel())
    close(np.concatenate(joined[0]), np.concatenate(joined[1]), rel, f"{what} joined")
    assert int(_np(unshard(want)["opt"]["step"])) == int(_np(unshard(got)["opt"]["step"]))


#: an update element is held relative to its leaf where its new second
#: moment is at least this share of the leaf's largest
WELL = 1e-4


def _adamw_explained(src_p, new_p, m, v, lr, step, what):
    """``new_p - src_p`` is AdamW's update from the new moments ``m``, ``v``
    (``optim.adamw.apply_updates`` in f64, OPT's b1, b2, eps and weight
    decay): within one ulp of the new value and 1e-6 of the update an
    element (the f32 rounding of the step)."""
    cfg = OptConfig(**OPT)
    old = torch.as_tensor(_np(src_p)).double()
    stepf = torch.tensor(float(step))
    c1, c2 = (float(1.0 - torch.pow(b, stepf)) for b in (cfg.b1, cfg.b2))  # f32, as AdamW's
    mhat = torch.as_tensor(_np(m)).double() / c1
    vhat = torch.as_tensor(_np(v)).double() / c2
    wd = cfg.weight_decay if old.dim() >= 2 else 0.0
    u = -lr * (mhat / (vhat.sqrt() + cfg.eps) + wd * old)
    got = torch.as_tensor(_np(new_p)).double() - old
    ulp = torch.as_tensor(np.spacing(np.abs(_np(new_p)))).double()
    assert bool(((got - u).abs() <= ulp + 1e-6 * u.abs()).all()), \
        f"{what}: the update is not AdamW's of its moments"


def _dense(m, shape) -> torch.Tensor:
    """A moment leaf as f32 values (an int8 one dequantized)."""
    if isinstance(m, dict):
        m = _dequantize({k: torch.as_tensor(_np(x)) for k, x in m.items()}, shape)
    return torch.as_tensor(_np(m)).double()


def check_step(src, want, got, lr, what, rel=1e-5, explained=False):
    """One step from the same input trainer state ``src``: ``want`` and
    ``got`` leaf by leaf (the module docstring).  With ``explained`` each
    param and master leaf's update is held to what AdamW makes of its own
    run's new moments (``_adamw_explained``) in place of the update rule
    (the moments keep theirs)."""
    sl, wl, gl = (dict(trainer_leaves(t)) for t in (src, want, got))
    assert list(wl) == list(gl), what
    held = 0
    for path, a in wl.items():
        b, where = gl[path], f"{what} {path}"
        if path[0] in ("m", "v"):
            if isinstance(a, dict):
                _q_close(a, b, rel, where)
            else:
                close(_np(a), b, rel, where)
            continue
        shape = tuple(a.shape)
        v = _dense(wl[("v",) + path[1:]], shape).sqrt()
        well = v >= WELL * v.max()
        old = torch.as_tensor(_np(sl[path])).double()
        da, db = torch.as_tensor(_np(a)).double() - old, torch.as_tensor(_np(b)).double() - old
        if explained:
            step = int(_np(unshard(src)["opt"]["step"])) + 1
            for t, new in ((want, a), (got, b)):
                tl = dict(trainer_leaves(t))
                _adamw_explained(sl[path], new, tl[("m",) + path[1:]], tl[("v",) + path[1:]], lr,
                                 step, where)
            held += 1
            continue
        close(da[well].numpy(), db[well], rel, f"{where} update")
        free = torch.zeros(shape, dtype=torch.bool)
        if isinstance(sl[("v",) + path[1:]], dict):
            free = (_dense(sl[("v",) + path[1:]], shape) == 0) & \
                (_dense(sl[("m",) + path[1:]], shape) != 0)
        rest = ~well & ~free
        assert bool(((da - db).abs()[rest] <= 2 * lr).all()), f"{where}: past 2 lr"
        held += int(well.sum())
    assert held > 0, what


@pytest.fixture(scope="module", params=["zero1", "fsdp"])
def case(request, tmp_path_factory):
    jax_res = run_child(request.param, tmp_path_factory)
    return request.param, jax_res, port_run(request.param, jax_res)


def test_loss_and_grad_norm_within_1e5_of_jax(case):
    name, jres, port = case
    for step, (jm, tm) in enumerate(zip(jres["metrics"], port["sharded"]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            close(jm[k], tm[k], 1e-5, f"{name} step {step} {k}")


def check_run(name, jres, want, got, explained=False):
    """Each step from JAX's input state leaf by leaf; the chained runs'
    last state joined (but for the quantized case, whose chained step-2
    state no float bound holds)."""
    for step, (a, b) in enumerate(zip(want["stepped"], got["stepped"])):
        check_step(jax_input(jres, step)["trainer"], a, b, float(jres["metrics"][step]["lr"]),
                   f"{name} step {step + 1}", explained=explained)
    if not CASES[name][2].get("quantized_state"):
        check_state(want["states"][-1], got["states"][-1], 1e-5, f"{name} chained")


def test_params_and_moments_within_1e5_of_jax(case):
    name, jres, port = case
    check_run(name, jres, {"stepped": jres["states"], "states": jres["states"]}, port["sharded"])


def test_sharded_equals_unsharded_within_1e5(case):
    name, jres, port = case
    check_run(name, jres, port["unsharded"], port["sharded"])
    for a, b in zip(port["sharded"]["metrics"], port["unsharded"]["metrics"]):
        for k in ("loss", "grad_norm"):
            close(a[k].numpy(), b[k], 1e-5, f"{name} {k}")


def test_batches_bitwise_and_data_stays_on_the_controller(case):
    name, jres, port = case
    final = port["sharded"]["final"]
    assert np.array_equal(np.asarray(jres["final"]["data"]["tokens"]), final["data"]["tokens"].numpy())
    assert not any(isinstance(x, Sharded) for x in tree_leaves(final["data"]))
    for a, b in zip(port["sharded"]["batches"], port["unsharded"]["batches"]):
        assert torch.equal(a, b)


def test_state_layout(case):
    """params by ``param_pspecs``, moments by ``zero_pspecs``: every
    member's block its own allocation, a replicated leaf one tensor."""
    name, _, port = case
    tr = port["sharded"]["final"]["trainer"]
    fsdp = CASES[name][1]
    wq = tr["params"]["segments"][0]["attn"]["wq"]
    assert tuple(wq.spec) == ((None, "data", "model") if fsdp else (None, None, "model"))
    m = tr["opt"]["m"]["segments"][0]["attn"]["wq"]
    m = m["q"] if isinstance(m, dict) else m
    assert "data" in [a for e in m.spec if e for a in (e if isinstance(e, tuple) else (e,))]
    for leaf in tree_leaves({"params": tr["params"], "opt": tr["opt"]}):
        if not isinstance(leaf, Sharded):
            continue
        ptrs = {}
        for c in leaf.coords():
            ptrs.setdefault(tuple((s.start, s.stop) for s in leaf.block(c)), set()).add(
                leaf.local(c).data_ptr())
        assert all(len(v) == 1 for v in ptrs.values())
        assert len({p for v in ptrs.values() for p in v}) == len(ptrs)
    assert not any(isinstance(x, Sharded) for x in tree_leaves(tr["metrics"]))


def test_paths_are_the_unsharded_ones():
    cfg, tcfg, ctx = port_setup("fsdp")
    sharded = TL.make_trainer_cell(cfg, tcfg, ctx).init(torch.Generator().manual_seed(0), "cpu")
    local = TL.make_trainer_cell(cfg, tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert tree_paths(sharded) == tree_paths(local)
    for a, b in zip(tree_leaves(unshard(sharded)), tree_leaves(local)):
        assert torch.equal(a, b)

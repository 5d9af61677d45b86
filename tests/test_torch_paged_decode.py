"""K5, paged single-query GQA decode: the port's plain version held to the
JAX package's Pallas kernel (interpret mode, as tests/test_paging.py runs
it) and to its reference ``paged_gqa_ref``, at atol = rtol = 1e-5 in f32
(different reduction order across frameworks, values O(1)).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.  Here: the wrapper's dispatch (CPU
tensors -> plain version) and its refusal of inputs the kernel does not
take.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_gqa_attention as jax_paged
from repro.kernels.ref import paged_gqa_ref
from repro_torch.kernels import paged_decode as pd

CASES = {
    # B, Hq, Hkv, Dk, ps, N, pages, pos
    "scattered_partial_one": (
        3, 4, 2, 8, 8, 10,
        [[7, 2, 9, 0], [5, 3, -1, -1], [8, -1, -1, -1]],
        [31, 11, 0],
    ),
    "unmapped_and_fully_masked": (
        4, 4, 2, 16, 4, 12,
        [[-1, -1, -1], [3, -1, 6], [11, 10, 9], [1, 4, -1]],
        [5, 9, 11, 2],
    ),
    "pos_at_page_edges": (
        3, 8, 2, 16, 8, 8,
        [[0, 1, 2, 3], [4, 5, 6, 7], [7, 6, 5, 4]],
        [7, 8, 15],
    ),
    "mqa_group8": (
        2, 8, 1, 32, 4, 6,
        [[5, 0, 3], [2, -1, 4]],
        [10, 11],
    ),
}


def make(case, dtype=np.float32, seed=0):
    B, Hq, Hkv, Dk, ps, N, pages, pos = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Dk)).astype(dtype)
    k = rng.normal(size=(N, Hkv, ps, Dk)).astype(dtype)
    v = rng.normal(size=(N, Hkv, ps, Dk)).astype(dtype)
    return q, k, v, np.asarray(pages, np.int32), np.asarray(pos, np.int32)


def torch_args(q, k, v, pages, pos):
    def t(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return [t(x) for x in (q, k, v, pages, pos)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_ref(case):
    args = make(case)
    ours = pd.paged_gqa_attention(*torch_args(*args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jax_paged(*jargs, interpret=True))
    ref = np.asarray(paged_gqa_ref(*jargs))
    np.testing.assert_allclose(ours, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_row_with_nothing_mapped_is_zero_and_masked_rows_average_v():
    """NEG_INF is finite: a row with no valid lane averages its gathered V
    lanes (zero when no page is mapped), like the JAX kernel — not NaN."""
    q, k, v, pages, pos = make("unmapped_and_fully_masked")
    out = pd.paged_gqa_attention(*torch_args(q, k, v, pages, pos)).numpy()
    assert np.all(out[0] == 0.0)  # nothing mapped
    pos2 = pos.copy()
    pos2[1] = -1  # mapped pages, no valid lane -> mean of gathered lanes
    out2 = pd.paged_gqa_attention(*torch_args(q, k, v, pages, pos2)).numpy()
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in (q, k, v, pages, pos2)],
                               interpret=True))
    np.testing.assert_allclose(out2, ref, atol=1e-5, rtol=1e-5)
    assert np.isfinite(out2).all()


def test_bf16_plain_within_tolerance_of_jax_ref():
    """bf16 inputs: f32 math, output rounded to bf16 — at most a couple of
    bf16 ulps (2**-8 relative) from the JAX reference."""
    args = make("pos_at_page_edges", dtype=ml_dtypes.bfloat16)
    ours = pd.paged_gqa_attention(*torch_args(*args)).float().numpy()
    ref = np.asarray(paged_gqa_ref(*[jnp.asarray(a) for a in args])).astype(np.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=2e-2)


def test_paged_plain_reduces_like_dense_decode_bitwise():
    """Within the port a paged decode equals the dense decode over the
    same lanes bit for bit (both run ``attend``): the paged-vs-dense
    token parity of the serving engine rests on it."""
    from repro_torch.models.layers import decode_attention

    q, k, v, pages, pos = torch_args(*make("scattered_partial_one"))
    paged = pd.paged_gqa_attention(q, k, v, pages, pos)
    kd, vd = pd.paged_gather(k, pages), pd.paged_gather(v, pages)
    ps = k.shape[2]
    lane = torch.arange(pages.shape[1] * ps)
    slot_pos = torch.where((pages >= 0).repeat_interleave(ps, 1), lane[None], -1)
    dense = decode_attention(q[:, :, None], kd, vd, slot_pos, pos)[:, :, 0]
    assert torch.equal(paged, dense)


def good_cuda_like():
    q, k, v, pages, pos = torch_args(*make("pos_at_page_edges"))
    return dict(q=q, k_pool=k, v_pool=v, pages=pages, pos=pos)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q=a["q"].double()), TypeError),
        (lambda a: a.update(pages=a["pages"].long()), TypeError),
        (lambda a: a.update(v_pool=a["v_pool"][:, :, :4]), ValueError),
        (lambda a: a.update(q=a["q"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda a: a.update(pos=a["pos"][:2]), ValueError),
        (lambda a: a.update(pages=torch.zeros((3, 8192), dtype=torch.int32)), ValueError),
    ],
    ids=["f64", "i64_pages", "pool_shape", "noncontiguous", "pos_len", "smem_over_227k"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_cuda_like()
    pd._check(**a)  # the good inputs pass
    mutate(a)
    with pytest.raises(err):
        pd._check(**a)


def test_non_cuda_non_cpu_tensor_raises():
    a = {k: v.to("meta") for k, v in good_cuda_like().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_gqa_attention(**a)


def test_default_device_without_cuda_raises():
    """Entry points default to cuda and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import bridge
    from repro_torch.core.executor import resolve_device

    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        bridge.states_from_numpy({"x": np.zeros(2, np.float32)})


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["paged_gqa_decode"])
    assert build.library_path("paged_gqa_decode").name.startswith("libpaged_gqa_decode-")

"""K5's partials entry point (``kernels.paged_decode.paged_gqa_partials``)
by its plain version, on the CPU: each row's flash-decoding partial
``(acc, m, l)`` over the lanes it is given.

``acc / l`` equals the normalised ``paged_gqa_plain`` output where a row
has a valid lane; a row without one (negative ``pos``, a member whose
lanes start past the query) is the empty partial m = -inf, l = 0, acc =
0, where the full kernel would take the uniform mean; cutting a dense
cache into 4 members' lane ranges, giving each its own view and ``pos``
shifted by its first lane, and combining the members' partials with
``distributed/decode.py``'s ``_combine_partials`` (pmax, alpha, psum) equals attention over
the whole cache; and on a dense view the partials equal the JAX
package's ``repro.distributed.decode._partial_attend`` (the math of its
sharded decode's member body) at every valid row.  On the card (the
``cuda``-marked case), the kernel against the plain version."""

import numpy as np
import pytest
import torch

from repro_torch.distributed import decode as DD
from repro_torch.kernels import paged_decode as pd
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def dense(B=3, Hq=8, Hkv=2, S=64, D=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g).to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("G", [1, 4, 12])
def test_partials_normalise_to_the_attention(G):
    q, k, v = dense(Hq=2 * G)
    pos = torch.tensor([0, 17, 63], dtype=torch.int32)
    acc, m, l = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    want = pd.paged_gqa_plain(q, *pd.dense_gqa_view(k, v), pos)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert torch.allclose(acc / l[..., None], want.float(), atol=1e-6, rtol=1e-5)
    assert (l >= 1).all() and torch.isfinite(m).all()
    assert pd.paged_gqa_partials.launches == 0  # CPU tensors take the plain version


def test_row_without_a_valid_lane_is_empty():
    q, k, v = dense()
    pos = torch.tensor([-1, -64, 5], dtype=torch.int32)
    acc, m, l = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    assert torch.isneginf(m[:2]).all() and (l[:2] == 0).all() and (acc[:2] == 0).all()
    assert torch.isfinite(m[2]).all() and (l[2] > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [[3, 40, 63], [0, 15, 16]])
def test_members_partials_combine_to_the_whole(dtype, pos):
    q, k, v = dense(dtype=dtype)
    pos = torch.tensor(pos, dtype=torch.int32)
    tp, S = 4, k.shape[2]
    S_l = S // tp
    parts = []
    for mbr in range(tp):
        ks, vs = k[:, :, mbr * S_l:(mbr + 1) * S_l].contiguous(), v[:, :, mbr * S_l:(mbr + 1) * S_l].contiguous()
        parts.append(pd.paged_gqa_partials(q, *pd.dense_gqa_view(ks, vs), pos - mbr * S_l))
    got = DD._combine_partials(*([p[i] for p in parts] for i in range(3)))
    # the partials are f32 whatever the inputs: compare with f32 attention
    want = pd.paged_gqa_plain(q.float(), *pd.dense_gqa_view(k.float(), v.float()), pos)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def test_partials_equal_jax_partial_attend():
    import jax.numpy as jnp  # here, not at the top: the card's cases run without JAX

    from repro.distributed import decode as JD

    q, k, v = dense(B=4, Hq=8, Hkv=2, S=32, D=16, seed=3)
    pos = torch.tensor([0, 9, 31, 20], dtype=torch.int32)
    S = k.shape[2]
    sp = torch.arange(S, dtype=torch.int32)[None].expand(4, S).clone()
    sp = torch.where(sp <= pos[:, None], sp, -1)  # a full cache: lane s holds position s
    scale = q.shape[-1] ** -0.5
    ctx, m, l = (np.asarray(a) for a in JD._partial_attend(
        jnp.asarray(q.numpy()[:, :, None]), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(pos.numpy()), None, scale))
    acc_t, m_t, l_t = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos, scale=scale)
    B, Hq, D = q.shape
    assert np.allclose(m_t.numpy(), m.reshape(B, Hq), atol=1e-6)
    assert np.allclose(l_t.numpy(), l.reshape(B, Hq), rtol=1e-5)
    assert np.allclose(acc_t.numpy(), ctx.reshape(B, Hq, D), rtol=1e-5, atol=1e-5)


def test_partials_refuse_other_devices():
    q, k, v = (x.to("meta") for x in dense())
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), torch.zeros(3, dtype=torch.int32,
                                                                        device="meta"))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card (K5's partials)")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_kernel_matches_plain_on_the_card(dtype):
    q, k, v = (x.cuda() for x in dense(B=8, Hq=48, Hkv=1, S=128, D=128, dtype=dtype))
    pos = torch.tensor([-3, 0, 5, 63, 64, 100, 127, 500], dtype=torch.int32, device="cuda")
    before = pd.paged_gqa_partials.launches
    got = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    assert pd.paged_gqa_partials.launches == before + 1
    want = pd.paged_gqa_partials_plain(q, *pd.dense_gqa_view(k, v), pos)
    for a, b in zip(got, want):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.allclose(a[fin], b[fin], rtol=1e-4, atol=1e-4)

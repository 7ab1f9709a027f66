"""The port's causal flash attention against the reference on the CPU:
``causal_attention`` and the wrapper ``flash_attention`` (whose CPU
tensors run the kernel's plain version) against the jnp oracle and the
Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s four
shapes (block_q > block_k, and Dv != D, among them).

Tolerances: float32 3e-4, the JAX test's own bound (the kernel's online
softmax sums in another order than the dense one); bfloat16 2e-2 (p is
rounded to bf16 before P·V on both sides, at different places), and the
per-element ``flash_attention_bf16_limit`` that ``chip_smoke.py`` and the
card tests hold the CUDA kernel to. That limit is checked here from both
sides at D = 128: the Pallas kernel's order stays inside it, and a plain
attention with a wrong mask in the late rows of a 2048-token sequence
(where outputs are small averages) falls outside it.

The bf16 kernel's TMA loads want rows of a multiple of 16 bytes, so its
wrapper pads D and Dv with zero columns and keeps the unpadded D's scale:
here the plain version on the padded operands equals the unpadded call bit
for bit once sliced back. The float32 kernel's ``cp.async`` pieces want the
same, and the padded float32 operands give the same attention (1e-6: the
plain product may sum the extra zeros in another order)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (the reference's kernels import through its core)
from repro.kernels.flash_attention import flash_attention as j_kernel
from repro.kernels.flash_attention import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import (causal_attention, flash_attention,
                                                 flash_attention_bf16_limit,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import tma_operands

SHAPES = [(4, 128, 32, 32, 32, 32), (2, 256, 64, 32, 64, 64),
          (8, 64, 16, 16, 32, 16), (2, 128, 32, 16, 16, 32)]


def _qkv(BH, S, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, S, D)).astype(np.float32),
            rng.standard_normal((BH, S, D)).astype(np.float32),
            rng.standard_normal((BH, S, Dv)).astype(np.float32))


@pytest.mark.parametrize("BH,S,D,Dv,bq,bk", SHAPES)
def test_float32_matches_reference(BH, S, D, Dv, bq, bk):
    q, k, v = _qkv(BH, S, D, Dv, seed=S + D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    wants = (np.asarray(j_ref(jq, jk, jv)),
             np.asarray(j_kernel(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    for got in (causal_attention(tq, tk, tv, block_q=bq, block_k=bk),
                flash_attention(tq, tk, tv, block_q=bq, block_k=bk),
                flash_attention_ref(tq, tk, tv)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (BH, S, Dv)
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_bfloat16_matches_reference():
    BH, S, D, Dv = 4, 128, 32, 16
    q, k, v = _qkv(BH, S, D, Dv, seed=9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    # float32 → bf16 rounds to nearest even in both frameworks: same inputs
    np.testing.assert_array_equal(np.asarray(jq.astype(jnp.float32)), tq.float().numpy())
    got = causal_attention(tq, tk, tv, block_q=32, block_k=64)
    assert got.dtype == torch.bfloat16
    limit = flash_attention_bf16_limit(tq, tk, tv, got).numpy()
    for want in (j_ref(jq, jk, jv), j_kernel(jq, jk, jv, block_q=32, block_k=64,
                                             interpret=True)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
        assert (np.abs(got.float().numpy() - want) <= limit).all()


def _bf16_qkv(BH, S, D, seed):
    return tuple(torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(BH, S, D, D, seed))


def test_bf16_limit_holds_the_pallas_kernels_order():
    """The reference's kernel (online softmax, unnormalised p rounded to
    bf16) against the port's dense plain version, D = 128 as in qwen3-14b."""
    tq, tk, tv = _bf16_qkv(2, 512, 128, seed=3)
    plain = flash_attention_ref(tq, tk, tv)
    limit = flash_attention_bf16_limit(tq, tk, tv, plain)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    other = np.asarray(j_kernel(jq, jk, jv, block_q=128, block_k=64,
                                interpret=True).astype(jnp.float32))
    diff = np.abs(other - plain.float().numpy())
    assert diff.max() > 0 and (diff <= limit.numpy()).all()


def _pos(S):
    i = torch.arange(S)
    return i[:, None], i[None, :], i[:, None] >= S // 2   # query, key, late row


FAULTS = {
    # the keys a faulty kernel lets each query see, against the causal mask
    "first key tile dropped": lambda q, k, late: (k <= q) & ~(late & (k < 64)),
    "key tile before the diagonal dropped":
        lambda q, k, late: (k <= q) & ~(late & (q - k >= 64) & (q - k < 128)),
    "one key past the diagonal": lambda q, k, late: (k <= q) | (late & (k == q + 1)),
    "diagonal key dropped": lambda q, k, late: (k < q) | (~late & (k == q)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_bf16_limit_rejects_a_wrong_mask_in_late_rows(fault):
    S = 2048
    tq, tk, tv = _bf16_qkv(2, S, 128, seed=5)
    plain = flash_attention_ref(tq, tk, tv)
    limit = flash_attention_bf16_limit(tq, tk, tv, plain)
    allowed = FAULTS[fault](*_pos(S))
    f32 = torch.float32
    s = torch.matmul(tq.to(f32), tk.to(f32).transpose(1, 2)) / np.sqrt(128)
    p = torch.softmax(torch.where(allowed[None], s, -1e30), dim=-1)
    wrong = torch.matmul(p.to(torch.bfloat16).to(f32), tv.to(f32)).to(torch.bfloat16)
    diff = (wrong.float() - plain.float()).abs()
    assert torch.equal(diff[:, :S // 2], torch.zeros_like(diff[:, :S // 2]))
    assert (diff > limit).any()


def test_first_query_attends_only_to_the_first_key():
    q, k, v = _qkv(2, 64, 16, 8, seed=1)
    out = causal_attention(*map(torch.as_tensor, (q, k, v)))
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("S,bq,bk", [(96, 64, 32), (128, 48, 64)])
def test_block_sizes_are_checked_as_the_reference_checks_them(S, bq, bk):
    q, k, v = _qkv(1, S, 8, 8)
    with pytest.raises(AssertionError):
        j_kernel(*map(jnp.asarray, (q, k, v)), block_q=bq, block_k=bk, interpret=True)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*map(torch.as_tensor, (q, k, v)), block_q=bq, block_k=bk)


@pytest.mark.parametrize("BH,S,D,Dv", [(3, 200, 7, 5), (2, 129, 1, 13), (2, 64, 36, 100),
                                       (1, 65, 121, 127)])
def test_zero_padding_for_tma_keeps_the_function(BH, S, D, Dv):
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(BH, S, D, Dv, seed=S + D))
    qp, kp, vp = tma_operands(q, k, v)
    Dp, Dvp = -(-D // 8) * 8, -(-Dv // 8) * 8
    assert tuple(qp.shape) == tuple(kp.shape) == (BH, S, Dp)
    assert tuple(vp.shape) == (BH, S, Dvp)
    for t, p in ((q, qp), (k, kp), (v, vp)):
        assert p.dtype == torch.bfloat16 and p.data_ptr() % 16 == 0
        assert torch.equal(p[..., :t.shape[-1]], t) and not p[..., t.shape[-1]:].any()
    out = flash_attention_ref(qp, kp, vp, head_dim=D)[..., :Dv]
    assert tuple(out.shape) == (BH, S, Dv) and out.dtype == torch.bfloat16
    assert torch.equal(out, flash_attention_ref(q, k, v))


@pytest.mark.parametrize("BH,S,D,Dv", [(3, 200, 7, 5), (2, 129, 1, 13), (2, 64, 34, 100)])
def test_zero_padding_for_float32_keeps_the_function(BH, S, D, Dv):
    """The float32 kernel's 16-byte loads take rows of a multiple of 4
    floats: the padded operands give the same attention once sliced back."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(BH, S, D, Dv, seed=S + D))
    qp, kp, vp = tma_operands(q, k, v)
    Dp, Dvp = -(-D // 4) * 4, -(-Dv // 4) * 4
    assert tuple(qp.shape) == tuple(kp.shape) == (BH, S, Dp)
    assert tuple(vp.shape) == (BH, S, Dvp)
    for t, p in ((q, qp), (k, kp), (v, vp)):
        assert p.dtype == torch.float32 and p.data_ptr() % 16 == 0
        assert torch.equal(p[..., :t.shape[-1]], t) and not p[..., t.shape[-1]:].any()
    out = flash_attention_ref(qp, kp, vp, head_dim=D)[..., :Dv]
    assert tuple(out.shape) == (BH, S, Dv)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v), rtol=1e-6, atol=1e-6)


def test_tma_operands_pass_aligned_tensors_through():
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    assert tma_operands(q)[0] is q
    # a view whose storage starts off a 16-byte boundary is copied
    off = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 64)
    (moved,) = tma_operands(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)

"""The port's pow2 weight format and pow2 matmul against the reference on
the CPU: ``pow2_quantize``/``pow2_dequantize`` and the LM-side
quantizers of ``core.quantize``, ``pow2_matmul_ref`` and ``pow2_linear``
(and the wrapper ``pow2_matmul``, whose CPU tensors run the kernel's plain
version) against the jnp oracle and the Pallas kernel in interpret mode at
``tests/test_kernels.py``'s shapes. The uint8 codes of the reference's
``pack_weights`` feed the port's ops unchanged: that is how weights carry
across.

Two faults of the reference on XLA:CPU shape the bounds here; the port
decodes and rounds exactly, so the card and the CPU agree:

* ``pow2_dequantize`` computes ``sign * exp2(e)``, and XLA:CPU's float32
  ``exp2`` misses the exact power of two on 189 of the 256 codes by up to
  2.03e-6 relative (jax 0.9.0). The port decodes by exponent insertion, bit
  for bit as the Pallas kernel's ``_decode_pow2``.
* ``pow2_quantize`` rounds ``log2|w|``, built from a float32 log that is a
  few ulps off near the rounding boundaries √2·2ᵏ: on the 2308 float32
  values within 4 ulps of them (k in −64…63, both signs, and four more) the
  reference's code differs from the correctly rounded one on 908 (jax
  0.9.0). The port's code is the correctly rounded one on all of them, and
  equals the reference's on seeded normal weights.

Matmul tolerances are the JAX test's: float32 1e-5, bfloat16 2e-2 (the sums
run in another order). The CUDA kernels' word decode (four codes per
32-bit word) and the wrapper's padding of ragged K and N are held here through
their plain twins: the decode bit for bit on every pair of codes, the
padding exactly on the plain version."""
import math
from fractions import Fraction

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (the reference's kernels import through its core)
from repro.core import quantize as jq
from repro.kernels.pow2_matmul import pack_weights as j_pack
from repro.kernels.pow2_matmul import pow2_linear as j_linear
from repro.kernels.pow2_matmul import pow2_matmul as j_kernel
from repro.kernels.pow2_matmul import pow2_matmul_ref as j_ref
from repro.kernels.pow2_matmul.kernel import _decode_pow2 as j_decode
from repro_torch.core import quantize as tq
from repro_torch.kernels.pow2_matmul import (pack_weights, pow2_linear, pow2_matmul,
                                             pow2_matmul_ref)
from repro_torch.kernels.pow2_matmul.kernel import (_decode_pow2, decode_pow2_word,
                                                    pad_operands)

CODES = np.arange(256, dtype=np.uint8)
MM_SHAPES = [(128, 128, 128, 128, 128, 128), (256, 384, 512, 128, 256, 128),
             (512, 256, 256, 128, 128, 64)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_is_the_kernels_exact_decode(dtype):
    want = np.asarray(j_decode(jnp.asarray(CODES), getattr(jnp, dtype)).astype(jnp.float32))
    for fn in (tq.pow2_dequantize, _decode_pow2):
        got = fn(torch.as_tensor(CODES), getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    assert want[0x7F] == 0 and want[0x3F] == 1.0 and want[0xBF] == -1.0


def test_dequantize_within_the_references_exp2_error():
    """XLA:CPU's ``exp2`` (the reference's ``pow2_dequantize``) is inexact:
    within 2.1e-6 relative of the exact decode, on every code."""
    want = np.asarray(jq.pow2_dequantize(jnp.asarray(CODES)))
    got = tq.pow2_dequantize(torch.as_tensor(CODES)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.1e-6, atol=0)
    assert got[0x7F] == want[0x7F] == 0.0


def test_quantize_matches_reference_on_seeded_weights():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(200_000) * 0.05).astype(np.float32)
    edge = np.array([0.0, -0.0, 1e-30, -1e-30, 2.0**-63, -(2.0**-63), 2.0**-70, 1e-45,
                     -1e-45, 1e-38, 1e30, -1e30, 2.0**63, 2.0**64, 3e38, -3e38,
                     np.inf, -np.inf], np.float32)
    for arr in (w, edge, w.reshape(400, 500)):
        want = np.asarray(jq.pow2_quantize(jnp.asarray(arr)))
        got = tq.pow2_quantize(torch.as_tensor(arr))
        assert got.dtype == torch.uint8 and tuple(got.shape) == arr.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pack_weights(torch.as_tensor(w)).numpy(),
                                  np.asarray(j_pack(jnp.asarray(w))))


def _correct_exponent(v: float) -> int:
    """round(log2 |v|), exactly: e + 1 where |v| >= √2·2^e (|v|² >= 2^(2e+1))."""
    a = abs(Fraction(v))
    e = math.frexp(v)[1] - 1                        # 2^e <= |v| < 2^(e+1)
    return e + (a * a >= Fraction(2) ** (2 * e + 1))


def test_quantize_rounds_correctly_at_the_boundaries():
    near = []
    for k in range(-64, 64):
        c = np.array([math.sqrt(2) * 2.0**k], np.float32).view(np.int32)[0]
        near += [np.array([c + d], np.int32).view(np.float32)[0] for d in range(-4, 5)]
    near = np.array(near, np.float32)
    vals = np.concatenate([near, -near, np.array([0.75, 1.5, -2.9, 2.0**-63], np.float32)])
    exps = np.clip([_correct_exponent(float(v)) for v in vals], -63, 63)
    want = (((vals < 0).astype(np.int32) << 7) | (exps + 63)).astype(np.uint8)
    got = tq.pow2_quantize(torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(vals) == 2308
    # the reference's float32 log rounds some of those next to √2·2ᵏ the
    # other way (908 with jax 0.9.0); the four further off it rounds right
    ref = np.asarray(jq.pow2_quantize(jnp.asarray(vals)))
    n_off = int((ref != want).sum())
    assert n_off <= 2 * len(near) and np.array_equal(ref[-4:], want[-4:]), n_off


def test_other_quantizers_match_reference():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 96)) * 0.3).astype(np.float32)
    w[3] = 0.0
    for axis in (-1, 0):
        qj, sj = jq.int8_quantize(jnp.asarray(w), axis=axis)
        qt, st = tq.int8_quantize(torch.as_tensor(w), axis=axis)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(np.asarray(sj)))
        np.testing.assert_array_equal(
            _bits(tq.int8_dequantize(qt, st).numpy()),
            _bits(np.asarray(jq.int8_dequantize(qj, sj))))
    for bits, frac in ((8, 4), (8, 6), (4, 2)):
        np.testing.assert_array_equal(
            tq.fixed_point_quantize(torch.as_tensor(w * 5), bits, frac).numpy(),
            np.asarray(jq.fixed_point_quantize(jnp.asarray(w * 5), bits, frac)))
    np.testing.assert_allclose(float(tq.pow2_quantization_error(torch.as_tensor(w))),
                               float(jq.pow2_quantization_error(jnp.asarray(w))), rtol=1e-5)


def _xw(M, K, N, dtype, seed=0):
    """x in ``dtype`` for both packages (float32 → bf16 rounds to nearest
    even in both) and the reference's packed weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wp = np.array(j_pack(jnp.asarray((rng.standard_normal((K, N)) * 0.1).astype(np.float32))))
    return jnp.asarray(x, getattr(jnp, dtype)), torch.as_tensor(x).to(getattr(torch, dtype)), wp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn,bk", MM_SHAPES)
def test_pow2_matmul_matches_reference(M, K, N, bm, bn, bk, dtype):
    xj, xt, wp = _xw(M, K, N, dtype, seed=M + K)
    wants = (np.asarray(j_ref(xj, jnp.asarray(wp))),
             np.asarray(j_kernel(xj, jnp.asarray(wp), bm=bm, bn=bn, bk=bk, interpret=True)))
    wt = torch.as_tensor(wp)
    for got in (pow2_matmul_ref(xt, wt), pow2_matmul(xt, wt),
                pow2_linear(xt, wt)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pow2_linear_keeps_leading_axes(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    wp = np.array(j_pack(jnp.asarray(rng.standard_normal((128, 256)) * 0.1)))
    xj, xt = jnp.asarray(x, getattr(jnp, dtype)), torch.as_tensor(x).to(getattr(torch, dtype))
    want = np.asarray(j_linear(xj, jnp.asarray(wp), use_kernel=False))
    got = pow2_linear(xt, torch.as_tensor(wp))
    assert tuple(got.shape) == want.shape == (2, 4, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_all_zero_weights_give_exactly_zero():
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((128, 128)).astype(np.float32))
    wp = pack_weights(torch.zeros((128, 128)))
    assert (wp == tq.ZERO_CODE).all()
    for got in (pow2_matmul(x, wp), pow2_linear(x[None], wp)):
        assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("M,K,N,bm", [(96, 128, 128, 64), (128, 100, 128, 128)])
def test_block_sizes_are_checked_as_the_reference_checks_them(M, K, N, bm):
    """The reference refuses blocks that do not divide the shapes; the port
    takes no block sizes (its kernel masks ragged edges), so the same
    shapes run and equal the plain version and the reference's oracle."""
    xj, xt, wp = _xw(M, K, N, "float32")
    with pytest.raises(AssertionError):
        j_kernel(xj, jnp.asarray(wp), bm=bm, bk=64, interpret=True)
    with pytest.raises(TypeError):
        pow2_matmul(xt, torch.as_tensor(wp), bm=bm, bk=64)
    got = pow2_matmul(xt, torch.as_tensor(wp))
    assert torch.equal(got, pow2_matmul_ref(xt, torch.as_tensor(wp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ref(xj, jnp.asarray(wp))),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_word_decode_is_the_references_decode_on_every_pair():
    """The kernels' branch-free decode of four codes in one 32-bit word,
    spelled out in integer ops (``decode_pow2_word``), equals
    ``_decode_pow2(…, jnp.bfloat16)`` bit for bit in every half, on all
    65,536 pairs of codes: word bytes (c0, c1, c1, c0) put each pair in
    both output words and both halves."""
    want = np.asarray(j_decode(jnp.asarray(CODES), jnp.bfloat16)).view(np.uint16)
    c0, c1 = (c.ravel().astype(np.int64) for c in
              np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    words = c0 | (c1 << 8) | (c1 << 16) | (c0 << 24)
    lo, hi = (t.numpy() for t in decode_pow2_word(torch.as_tensor(words)))
    assert min(lo.min(), hi.min()) >= 0 and max(lo.max(), hi.max()) < 2**32
    for got, first, second in ((lo, c0, c1), (hi, c1, c0)):
        np.testing.assert_array_equal(got & 0xFFFF, want[first])
        np.testing.assert_array_equal(got >> 16, want[second])
    # 0x7F is +0, 0xFF is -2^64, 0x00 is 2^-63: as bf16 bit patterns
    assert (want[0x7F], want[0xFF], want[0x00]) == (0x0000, 0xDF80, 0x2000)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,offset", [(77, 100, 130, 0), (1, 5, 3, 0), (300, 1030, 200, 0),
                                          (64, 128, 256, 1), (33, 64, 48, 0)])
def test_wrapper_padding_adds_exact_zeros(M, K, N, offset, dtype):
    """``pad_operands`` gives x (M, K8) with zero columns and the weights
    (K8, N16) with 0x7F rows and columns (K8, N16: K and N rounded up to 8
    and 16), each 16-byte aligned, copying an operand whose storage is not
    (``offset`` 1: x a view one element into its buffer); shapes that need
    nothing come back as the same tensors. The padded operands through the
    plain version give the unpadded call's output in their first N
    columns, up to the order of the float32 sums (the CPU's BLAS blocks the
    padded K another way): within K·2⁻²⁴·(|x|·|w|), the bound on a
    reordered float32 sum of K exact products."""
    _, xt, wp = _xw(M, K, N, dtype, seed=M + K + N)
    buf = torch.zeros(M * K + offset, dtype=xt.dtype)
    buf[offset:] = xt.reshape(-1)
    x = buf[offset:].view(M, K)
    w = torch.as_tensor(wp)
    xp, wq = pad_operands(x, w)
    k8, n16 = max(8, -(-K // 8) * 8), -(-N // 16) * 16
    assert tuple(xp.shape) == (M, k8) and tuple(wq.shape) == (k8, n16)
    assert xp.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    assert (xp is x) == (k8 == K and not offset) and (wq is w) == ((k8, n16) == (K, N))
    assert torch.equal(xp[:, :K], x) and not xp[:, K:].any()
    assert torch.equal(wq[:K, :N], w) and (wq[K:] == tq.ZERO_CODE).all()
    assert (wq[:, N:] == tq.ZERO_CODE).all()
    got = pow2_matmul_ref(xp, wq)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, n16)
    assert not got[:, N:].any()
    want = pow2_matmul_ref(x, w)
    bound = K * 2.0**-24 * (x.float().abs() @ tq.pow2_dequantize(w).abs())
    assert ((got[:, :N] - want).abs() <= bound).all()

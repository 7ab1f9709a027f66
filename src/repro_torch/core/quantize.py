"""Fixed-point and pow2 quantization (paper §III-A).

The port of ``repro.core.quantize``. Two regimes:

* printed-MLP: integer activations and pow2 weights held as (sign,
  exponent) gene pairs (``core.mlp``);
* LM: float tensors rounded to signed powers of two and stored one byte
  each (bit 7 the sign, bits 0..6 the exponent plus ``_EXP_BIAS``), which
  the ``pow2_matmul`` kernel consumes; and the int8 / fixed-point baselines.

Two choices differ from the reference on purpose, both to make the card and
the CPU agree exactly: :func:`pow2_dequantize` inserts the exponent bits
(the reference's ``sign * exp2(e)`` is inexact on XLA:CPU), and
:func:`pow2_quantize` rounds ``log2|w|`` correctly by an exact integer
compare of the mantissa against √2 (the reference's float32 log is a few
ulps off next to √2·2ᵏ).
"""
from __future__ import annotations

import math

import torch

# uint8 packing: bit 7 = sign (1 → negative), bits 0..6 = exponent + _EXP_BIAS.
# Exponents are clipped to [-_EXP_BIAS, 127 - _EXP_BIAS - 1]; code 0x7F
# (sign 0, exponent field all ones) is reserved for 0.0.
_EXP_BIAS = 63
ZERO_CODE = 0x7F
_EXP_LO, _EXP_HI = -_EXP_BIAS, 127 - _EXP_BIAS - 1
# A normal float32 with mantissa field m lies at or above √2·2^e (its own
# exponent e) iff (2^23 + m)^2 >= 2^47, i.e. m >= _SQRT2_MANT.
_SQRT2_MANT = math.isqrt(2**47 - 1) + 1 - 2**23


def quantize_inputs(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[0,1] float32 → unsigned ``bits``-bit int32 (paper: 4-bit inputs).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    hi = 2**bits - 1
    return torch.clamp(torch.round(x * hi), 0, hi).to(torch.int32)


def qrelu(acc: torch.Tensor, rshift: torch.Tensor, out_bits: int) -> torch.Tensor:
    """QReLU: arithmetic right shift by the rescale gene, then clamp to
    ``[0, 2**out_bits - 1]`` (paper §III-B)."""
    return torch.clamp(torch.bitwise_right_shift(acc, rshift), 0, 2**out_bits - 1)


# ---------------------------------------------------------------------------
# LM-scale pow2 weight quantization (packed uint8 storage)
# ---------------------------------------------------------------------------

def pow2_quantize(w: torch.Tensor) -> torch.Tensor:
    """Round a float tensor to signed powers of two; return packed uint8.

    w ≈ sign(w) · 2^round(log2|w|), the exponent correctly rounded and
    clipped to [-63, 63]. Zeros of either sign, and subnormals (which
    XLA flushes to zero on the reference's CPU and TPU), map to
    ``ZERO_CODE``.
    """
    w = w.to(torch.float32)
    sign = (w < 0).to(torch.int32)
    mag = w.abs()
    # clamp into normal floats (2^-63 is the reference's floor, 2^64 rounds
    # to 64 and clips like inf), then read exponent and mantissa bits
    bits = mag.clamp(2.0**-_EXP_BIAS, 2.0**64).view(torch.int32)
    exp = ((bits >> 23) - 127) + ((bits & 0x7FFFFF) >= _SQRT2_MANT).to(torch.int32)
    exp = exp.clamp(_EXP_LO, _EXP_HI)
    code = (sign << 7) | (exp + _EXP_BIAS)
    return torch.where(mag < 2.0**-126, ZERO_CODE, code).to(torch.uint8)


def pow2_dequantize(code: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed uint8 → float powers of two, exactly: the exponent is inserted
    into a float32's exponent field (as the Pallas kernel's
    ``_decode_pow2``), the sign from bit 7; ``ZERO_CODE`` → 0."""
    c = code.to(torch.int32)
    exp = (c & 0x7F) - _EXP_BIAS
    mag = ((exp + 127) << 23).view(torch.float32)
    val = torch.where((c >> 7) & 1 == 1, -mag, mag)
    return torch.where(c == ZERO_CODE, torch.zeros_like(val), val).to(dtype)


def pow2_quantization_error(w: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius error of pow2 rounding (used by the LM search)."""
    wq = pow2_dequantize(pow2_quantize(w))
    return torch.linalg.norm(w - wq) / torch.clamp_min(torch.linalg.norm(w), 1e-12)


def int8_quantize(w: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 (baseline format in the LM search space)
    → (int8 codes, float scale with ``axis`` kept)."""
    scale = torch.amax(w.abs(), dim=axis, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)


def fixed_point_quantize(w: torch.Tensor, bits: int, frac_bits: int) -> torch.Tensor:
    """Exact-baseline fixed point (Table I: '8-bit fixed point weights')."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(w * 2**frac_bits), lo, hi).to(torch.int32)

# float32 exponent manipulation (port of rmt_tpu/ops/floatbits.py), used
# by ops/accurate_math.py's range reductions.
#
# frexp_pos and ldexp2 equal the reference's bit for bit on the domain the
# transcendentals use:
#
#   * frexp_pos: positive NORMAL finite float32. Zero, denormal, negative
#     and infinite inputs give meaningless mantissas; callers guard
#     (accurate_math.log returns the native log for x < the smallest
#     normal).
#   * ldexp2: exact for |k| <= 253; beyond that the two-step product
#     saturates to inf or flushes to 0, as exp's overflow and underflow
#     should.
#
# The reference reads and writes the exponent field through bit casts.
# Here no tensor is viewed as another dtype: the colored Jacobians map the
# DSL over members with torch.func.vmap, and PyTorch (2.11 on the card)
# has no batching rule for a dtype view. So 2^e for an integer e comes
# from a table of the 254 normal powers of two (exact), and the exponent
# of x from floor(log2 x), corrected by one step either way until the
# mantissa x 2^-e lies in [0.5, 1): the unique frexp, so the same bits as
# the reference's bit field. The generated CUDA kernel (ops/cuda_rhs.py,
# am_source) reads the field with __float_as_int; the results are equal.
#
# Derivatives. The exponent carries none (it is computed from the
# detached x); the mantissa is the exact product x * 2^-e, so its
# derivative is 2^-e, as rmt_tpu's stop_gradient lets it.

from __future__ import annotations

import math

import torch

_I32 = torch.int32
_F32 = torch.float32
_tables: dict = {}


def pow2(e):
    """2^e as float32 for int32 e in [-126, 127] (exact)."""
    table = _tables.get(e.device)
    if table is None:
        table = torch.tensor([math.ldexp(1.0, k) for k in range(-126, 128)],
                             dtype=_F32, device=e.device)
        _tables[e.device] = table
    return table[(e + 126).long()]


def frexp_pos(x):
    """(m, e) with x = m * 2^e, m in [0.5, 1), for positive normal f32 x.

    The exponent (int32) comes from the detached x (no derivative); the
    mantissa is the exact product x * 2^-e, so its derivative is 2^-e."""
    xd = x.detach()
    e = torch.floor(torch.log2(xd)).to(_I32) + 1
    m = ldexp2(xd, -e)
    e = e + (m >= 1.0).to(_I32) - (m < 0.5).to(_I32)
    return ldexp2(x, -e), e


def ldexp2(x, k):
    """x * 2^k for int32 k by two exact power-of-two multiplications."""
    k = k.detach().to(_I32)
    k1 = torch.clamp(k, -126, 127)
    k2 = torch.clamp(k - k1, -126, 127)
    return (x * pow2(k1)) * pow2(k2)

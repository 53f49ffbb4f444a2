"""float32 math as XLA:CPU computes it, so the samplers match bit for bit.

The JAX package's samplers run compiled by XLA:CPU, and three of its habits
change float32 results:

1. LLVM contracts ``a*b + c`` into one fused multiply-add when the product
   has no other use.  :func:`fma32` computes ``a*b + c`` rounded once.
2. ``sqrt`` is correctly rounded.  :func:`sqrt` takes it in float64 and
   rounds once (torch's CPU ``sqrt`` is off by an ulp on some inputs; the
   float64 route is correctly rounded on both devices).
3. ``log`` is the Cephes polynomial (XLA's ``xla.log.f32``), not the libm
   one, with the contractions LLVM makes in it; ``log1p`` is XLA's rational
   approximation for small arguments and that ``log`` of ``1 + x`` beyond.
   :func:`log` and :func:`log1p` replay both, operation by operation.

Subnormal inputs read as zero, as under XLA:CPU's denormals-are-zero mode
(:func:`daz`).

Everything here is plain torch on float32 tensors and runs on either
device.  Each elementwise torch op rounds once, as IEEE arithmetic does, so
a sequence of them reproduces the compiled program wherever the compiled
program did not fuse.  Division goes through :func:`div`, never through a
Python-scalar divisor: torch may turn ``x / c`` and ``c / x`` into a product
with a reciprocal, which rounds twice.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_F64 = torch.float64

# XLA's Cephes log (llvm_ir log_f32): constants as float32
_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_FLT_MIN = float(np.finfo(np.float32).tiny)

# XLA's log1p for |x| < sqrt(2) - 1: x - x²/2 + x³·P(x)/Q(x) (Cephes)
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))
_LOG1P_NUM = tuple(float(np.float32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))

_MID_BITS = (1 << 29) - 1  # float64 mantissa bits below float32 precision


def fma32(a, b, c):
    """float32 ``a*b + c`` rounded once (a fused multiply-add).

    The product of two float32 values is exact in float64; the sum is
    rounded to float64 and then to float32.  That double rounding differs
    from a single one only when the float64 sum lands exactly on a float32
    rounding midpoint with a nonzero remainder; then the sum is moved one
    float64 ulp toward the remainder (its sign from an exact two-sum), which
    puts it on the side the exact value lies on."""
    like = next(v for v in (a, b, c) if torch.is_tensor(v))

    def f64(v):  # a Python number is a float32 constant, as in JAX
        return v.to(_F64) if torch.is_tensor(v) else torch.full_like(
            like, float(np.float32(v)), dtype=_F64)

    p = f64(a) * f64(b)
    c64 = f64(c)
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    mid = (s.view(torch.int64) & _MID_BITS) == (1 << 28)
    nudge = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                            .to(_F64))
    return torch.where(mid & (err != 0), nudge, s).to(_F32)


def div(a, b):
    """float32 ``a / b`` rounded once, either operand a Python number."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, float(a))
    if not torch.is_tensor(b):
        b = torch.full_like(a, float(b))
    return torch.div(a, b)


def daz(x):
    """Subnormal inputs read as (signed) zero: XLA:CPU runs with the
    denormals-are-zero and flush-to-zero modes on."""
    x = x.to(_F32)
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def sqrt(x):
    """Correctly rounded float32 square root (subnormals read as zero)."""
    return torch.sqrt(daz(x).to(_F64)).to(_F32)


def log(x):
    """float32 natural log, bit-equal to XLA:CPU's ``jnp.log``."""
    x = daz(x)
    xi = torch.clamp(x, min=_FLT_MIN).view(torch.int32)
    m = ((xi & 0x007FFFFF) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    e = ((xi >> 23) - 127).to(_F32) + 1.0
    small = m < _SQRTHF
    e = e - small.to(_F32)
    f = (m - 1.0) + torch.where(small, m, 0.0)
    f2 = f * f
    f3 = f2 * f
    p = _LOG_P
    y = fma32(f, p[0], p[1])
    y1 = fma32(f, p[3], p[4])
    y2 = fma32(f, p[6], p[7])
    y = fma32(y, f, p[2])
    y1 = fma32(y1, f, p[5])
    y2 = fma32(y2, f, p[8])
    y = fma32(y, f3, y1)
    y = fma32(y, f3, y2)
    y = fma32(y, f3, e * _LOG_Q1)
    t = f - f2 * 0.5  # exact: the product is a power-of-two scaling
    t = t + y
    r = fma32(e, _LOG_Q2, t)
    r = torch.where(x == 0, -torch.inf, r)
    r = torch.where(x == torch.inf, torch.inf, r)
    return torch.where((x < 0) | torch.isnan(x), torch.nan, r)


def log1p(x):
    """float32 ``log(1 + x)``, bit-equal to XLA:CPU's ``jnp.log1p``."""
    x = daz(x)
    x2 = x * x
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma32(num, x, c)
    den = torch.ones_like(x)
    for c in _LOG1P_DEN[1:]:
        den = fma32(den, x, c)
    small = fma32(x2, -0.5, (x * x2) * div(num, den))
    small = x + small
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))

"""float32 ``exp``, ``log``, ``log1p``, ``sin`` and ``cos`` that round like
the reference.

The stepping heuristic quantises ``ratio`` (Eq. 2, an ``exp``/``log1p``
expression) onto the 4096-entry weight LUT, and the degree histogram
buckets ``floor(log2(deg))``.  A one-ulp difference in either moves a
window edge or a bucket, which changes the logical counters that the
port must reproduce exactly.  The reference's numbers come from XLA's
CPU lowering, which expands these functions into fixed Cephes-style
polynomials, and its x86 backend contracts most multiply-add pairs of
those polynomials into fused multiply-adds.  The functions below
evaluate the same polynomials in the same order and fuse the same
pairs.  Each fused multiply-add is emulated by :func:`fma` as an exact
float64 product plus a sum rounded to float64 and then to float32; the
remaining multiplies and adds are plain float32 ops.  The results are
the same bits on any device, except where that double rounding of a
sum meets a tie at both widths, which a true fused multiply-add would
round once (no such input has been seen).

:func:`sqrt` is the correctly rounded float32 square root on every
device: torch's float32 ``sqrt`` need not be, and a CPU build and the
card have given DimeNet edge lengths an ulp apart.

DimeNet's radial and spherical bases (``models/gnn/dimenet.py``) take
``sin`` and ``cos`` of float32 arguments, and its spherical Bessel
recurrence turns a one-ulp difference into a large one where the
argument is short.  XLA:CPU calls the C library's ``sinf``/``cosf``
(glibc's, from its float32 code for ``|x| < 120``); :func:`sinf` and
:func:`cosf` evaluate that code's float64 steps with plain float64 adds
and multiplies, which give the same bits on any device.
"""
from __future__ import annotations

import struct

import torch


def _c(bits: int) -> float:
    """A float32 constant written as the double that holds it."""
    return float(struct.unpack(">d", bits.to_bytes(8, "big"))[0])


_EXP_LO = _c(0xC055F33340000000)
_EXP_HI = _c(0x4056333340000000)
_LOG2E = _c(0x3FF7154760000000)
_LN2_HI = _c(0x3FE6300000000000)          # 0.693359375
_LN2_LO = _c(0xBF2BD01060000000)          # -2.12194440e-4
_EXP_P = tuple(_c(b) for b in (0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                               0x3F81112100000000, 0x3FA5553820000000,
                               0x3FC5555540000000))
_TINY = _c(0x3810000000000000)            # smallest normal float32
_SQRT_HALF = _c(0x3FE6A09E60000000)
_LOG_P = tuple(_c(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000,
                               0xBFBFCBA9E0000000, 0x3FC23D37E0000000,
                               0x3FC999D580000000, 0xBFCFFFFF80000000,
                               0x3FBDE4A340000000, 0xBFC555CA00000000,
                               0x3FD5555540000000))
_LOG1P_Q = tuple(_c(b) for b in (0x402E2035A0000000, 0x4054C30B60000000,
                                 0x406BB865A0000000, 0x4073519460000000,
                                 0x406B0DB140000000, 0x404E0F3040000000))
_LOG1P_P = tuple(_c(b) for b in (0x3F07BC0960000000, 0x3FDFE818A0000000,
                                 0x401A509F40000000, 0x403DE97380000000,
                                 0x404E798EC0000000, 0x404C8E75A0000000,
                                 0x40340A2020000000))
_LOG1P_SMALL = _c(0x3FDA8279A0000000)     # sqrt(2) - 1
LOG2_SCALE = _c(0x3FF7154760000000)       # log2(x) = log(x) * this


def fma(a, b, c):
    """Fused ``a * b + c`` with one rounding: the float64 product of two
    float32 values is exact, so only the final sum rounds (twice, to
    float64 then float32; a tie at both roundings is the only way this
    differs from a true fused multiply-add)."""
    a, b, c = (t.double() if isinstance(t, torch.Tensor) else t
               for t in (a, b, c))
    return (a * b + c).float()


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` (finite inputs)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(fx, -_LN2_LO, fma(fx, -_LN2_HI, x))
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma(p, r, c)
    p = fma(p, r, 0.5)
    p = 1.0 + fma(p, r * r, r)
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * pow2


def log(y: torch.Tensor) -> torch.Tensor:
    """float32 natural log (inputs > 0)."""
    bits = torch.where(y > _TINY, y, torch.full_like(y, _TINY)) \
        .view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = x * x
    x3 = z * x
    t1 = fma(fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[6])
    t2 = fma(fma(x, _LOG_P[2], _LOG_P[3]), x, _LOG_P[7])
    t3 = fma(fma(x, _LOG_P[4], _LOG_P[5]), x, _LOG_P[8])
    u = fma(fma(t1, x3, t2), x3, t3)
    u = fma(u, x3, e * _LN2_LO)
    return fma(e, _LN2_HI, fma(z, -0.5, x) + u)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` (inputs > -1)."""
    x2 = x * x
    q = fma(fma(x, 0.0, 1.0), x, _LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    p = fma(x, 0.0, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt``, correctly rounded (IEEE) on any device: the
    float64 root rounded to float32, then moved by one ulp where the
    square of a rounding midpoint (exact in float64) shows it on the
    wrong side."""
    return _nearest_root(x, torch.sqrt(x.double()).float())


def _nearest_root(x, y):
    """The float32 root of ``x`` nearest to the true one, from a candidate
    ``y`` at most one ulp away."""
    inf = torch.full_like(y, float("inf"))
    down, up = torch.nextafter(y, -inf), torch.nextafter(y, inf)
    xd, yd = x.double(), y.double()
    lo, hi = (yd + down.double()) * 0.5, (yd + up.double()) * 0.5
    fix = (x > 0) & torch.isfinite(x)
    y = torch.where(fix & (xd < lo * lo), down, y)
    return torch.where(fix & (xd > hi * hi), up, y)


# glibc's float32 sin/cos (sysdeps/ieee754/flt-32: reduce_fast, sinf_poly
# and __sincosf_table) for |x| < 120: 2/pi scaled by 2^24, pi/2, the cos
# polynomial c0..c4 and the sin polynomial s1..s3, all float64
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COS_P = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_P = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
SINCOS_LIMIT = 120.0        # glibc changes its reduction at |x| >= 120


def _sincos_poly(x, x2, odd, neg_cos):
    """glibc's ``sinf_poly``: the sin polynomial where ``odd`` is false,
    the cos polynomial (negated where ``neg_cos``) where it is true."""
    x3 = x * x2
    s = (x + x3 * _SIN_P[0]) + (x3 * x2) * (_SIN_P[1] + x2 * _SIN_P[2])
    sign = torch.where(neg_cos, -1.0, 1.0).double()
    c = [sign * k for k in _COS_P]
    x4 = x2 * x2
    cos = ((c[0] + x2 * c[1]) + x4 * c[2]) + (x4 * x2) * (c[3] + x2 * c[4])
    return torch.where(odd, cos, s)


def _sincos(y: torch.Tensor, cos: bool) -> torch.Tensor:
    # (no values to check on ``meta``, the dry-run's shape trace)
    if y.device.type != "meta" and bool((y.abs() >= SINCOS_LIMIT).any()):
        raise ValueError(f"f32math.sinf/cosf cover |x| < {SINCOS_LIMIT}")
    a = y.abs()
    x = y.double()
    # reduce_fast: the quadrant n in bits 24..31 of x * 2/pi * 2^24
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = x - n.double() * _HPI
    sign = torch.where((n & 3 == 1) | (n & 3 == 2), -1.0, 1.0).double()
    quad = (n ^ 1) if cos else n
    reduced = _sincos_poly(r * sign, r * r, (quad & 1) == 1, (n & 2) == 2)
    near = _sincos_poly(x, x * x,
                        torch.full_like(n, int(cos), dtype=torch.bool),
                        torch.zeros_like(n, dtype=torch.bool))
    out = torch.where(a < 0.75, near, reduced).float()
    tiny = torch.ones_like(y) if cos else y
    return torch.where(a < 2.0 ** -12, tiny, out)


def sinf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sin``, glibc's ``sinf`` bit for bit (``|x| < 120``; raises
    beyond, where glibc reduces another way).  Without a reduction for
    ``|x| < 0.75`` (glibc's test on the top 12 bits against pi/4), ``x``
    itself for ``|x| < 2^-12``."""
    return _sincos(x, cos=False)


def cosf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``cos``, glibc's ``cosf`` bit for bit (``|x| < 120``; raises
    beyond); 1 for ``|x| < 2^-12``."""
    return _sincos(x, cos=True)

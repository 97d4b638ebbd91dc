"""Backend-exact software exponential (the portable libm story).

hetIR's conformance contract is one-op-one-rounding bit-identity across
every backend.  Basic IEEE ops (``+ - * / sqrt``) are correctly rounded
everywhere, but ``EXP`` is a libm call and libms disagree in the low bits
(NumPy's, PyTorch's CPU and CUDA kernels, and the CUDA math library all
differ).  So ``EXP`` is evaluated from correctly rounded primitives only,
with one operation sequence shared by every substrate:

* range reduction ``x = k·ln2 + r`` with a two-term ``ln2`` split
  (Cody–Waite; the high part has enough trailing zero bits that
  ``k · LN2_HI`` is exact for every |k| ≤ 150),
* a degree-6 minimax polynomial on ``|r| ≤ ln2/2`` (the Cephes ``expf``
  coefficients: ``exp(r) ≈ 1 + r + r²·P(r)``), evaluated by Horner with
  one rounding per multiply/add,
* reconstruction by two exact powers of two built with integer bit
  manipulation (``(e+127) << 23`` reinterpreted as f32), split
  ``k = k₁ + k₂`` so subnormal/overflow outputs round exactly once, in the
  final multiply.

:func:`exp_np` (NumPy, the interpreter and the oracles) and
:func:`exp_torch` (eager PyTorch, the plain version of the CUDA segment
kernels) run :func:`_exp_core` op for op; the CUDA device helper
``het_exp_f32`` in ``csrc/hetir_rt.cuh`` replays the same sequence with
``__fmul_rn``/``__fadd_rn``/``rintf``.  All three are bit-identical for
every float32 input.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["exp_np", "exp_torch", "EXP_MAX_INPUT", "EXP_MIN_INPUT"]

#: inputs above this produce +inf, below :data:`EXP_MIN_INPUT` produce +0
#: (with flush-to-zero, underflow effectively begins near ln(2^-126))
EXP_MAX_INPUT = np.float32(88.72283)
EXP_MIN_INPUT = np.float32(-103.972084)

_FLT_MIN_NORMAL = np.float32(1.1754943508222875e-38)  # 2^-126

_LOG2E = np.float32(1.44269504088896341)
_LN2_HI = np.float32(0.693359375)        # 0x1.63p-1: 11 trailing zero bits
_LN2_LO = np.float32(-2.12194440e-4)
#: Cephes expf minimax: exp(r) = 1 + r + r^2 * P(r) on |r| <= ln2/2
_POLY = (np.float32(1.9875691500e-4), np.float32(1.3981999507e-3),
         np.float32(8.3334519073e-3), np.float32(4.1665795894e-2),
         np.float32(1.6666665459e-1), np.float32(5.0000001201e-1))


def _exp_core(x, o):
    """One shared op sequence; ``o`` supplies the array substrate.  Every
    ``o.add/sub/mul`` is exactly one IEEE float32 rounding."""
    one = o.f32(1.0)
    # sanitize so the int cast below never sees NaN; the final selects
    # restore NaN / overflow / underflow from the *original* x
    xs = o.where(o.isnan(x), o.f32(0.0), x)
    xs = o.minimum(o.maximum(xs, o.f32(-104.0)), o.f32(89.0))
    k = o.rint(o.mul(xs, o.f32(_LOG2E)))       # exact: rint of one product
    r = o.sub(xs, o.mul(k, o.f32(_LN2_HI)))    # k*LN2_HI exact, sub exact
    r = o.sub(r, o.mul(k, o.f32(_LN2_LO)))
    p = o.f32(_POLY[0])
    for c in _POLY[1:]:
        p = o.add(o.mul(p, r), o.f32(c))
    rr = o.mul(r, r)
    y = o.add(o.add(o.mul(rr, p), r), one)
    # 2^k as two exact scale factors: k in [-151, 129] after the clamp,
    # so both halves stay in the normal exponent range [-76, 65]
    ki = o.to_i32(k)
    k1 = o.shr1(ki)
    y = o.mul(o.mul(y, o.pow2(k1)), o.pow2(o.isub(ki, k1)))
    # flush-to-zero on subnormal outputs: part of the exp contract (the
    # JAX reference's XLA CPU kernels run FTZ, and every substrate adopts
    # it through this select)
    y = o.where(y < o.f32(_FLT_MIN_NORMAL), o.f32(0.0), y)
    y = o.where(x > o.f32(EXP_MAX_INPUT), o.f32(np.inf), y)
    y = o.where(x < o.f32(EXP_MIN_INPUT), o.f32(0.0), y)
    return o.where(o.isnan(x), x, y)


class _NpOps:
    """NumPy substrate: one rounding per op natively."""
    f32 = staticmethod(np.float32)
    add = staticmethod(np.add)
    sub = staticmethod(np.subtract)
    mul = staticmethod(np.multiply)
    rint = staticmethod(np.rint)
    where = staticmethod(np.where)
    minimum = staticmethod(np.minimum)
    maximum = staticmethod(np.maximum)
    isnan = staticmethod(np.isnan)

    @staticmethod
    def to_i32(v):
        return np.asarray(v).astype(np.int32)

    @staticmethod
    def shr1(v):
        return v >> 1                       # arithmetic: floor halving

    @staticmethod
    def isub(a, b):
        return a - b

    @staticmethod
    def pow2(e):
        return ((e + np.int32(127)) << np.int32(23)).view(np.float32)


def exp_np(x):
    """float32 exp on the numpy substrate (scalars or arrays).  Returns
    the same shape; scalar in, numpy scalar out."""
    arr = np.asarray(x, dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        out = np.asarray(_exp_core(arr, _NpOps), dtype=np.float32)
    return out if out.ndim else np.float32(out)


class _TorchOps:
    """Eager PyTorch substrate on one device.  Each elementwise call is its
    own kernel, so no multiply-add contraction can happen between ops, and
    float32 ``+``/``-``/``*`` are single IEEE roundings on CPU and CUDA."""

    def __init__(self, device: torch.device):
        self.device = device

    def f32(self, v):
        return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=self.device)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def rint(v):
        return torch.round(v)               # half to even, like np.rint

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, b)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, b)

    @staticmethod
    def isnan(v):
        return torch.isnan(v)

    @staticmethod
    def to_i32(v):
        return v.to(torch.int32)            # exact: |k| <= 151 here

    @staticmethod
    def shr1(v):
        return v >> 1

    @staticmethod
    def isub(a, b):
        return a - b

    @staticmethod
    def pow2(e):
        return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def exp_torch(x: torch.Tensor) -> torch.Tensor:
    """float32 exp on a torch tensor — bit-identical to :func:`exp_np` for
    every input, on CPU and on CUDA."""
    x = x.to(torch.float32)
    return _exp_core(x, _TorchOps(x.device))

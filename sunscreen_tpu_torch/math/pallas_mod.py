"""Exact 64-bit modular multiplies of the u64 engine, elementwise: the
port of `sunscreen_tpu/math/pallas_mod.py` (kernel B18).

* `shoup_mul_mod(x, w, w_sh, q)`: x w mod q for x in [0, 2q), w < q and
  w_sh = floor(w 2^64 / q), the same result as
  `reduce_2q(mul_mod_shoup(x, w, w_sh, q))`;
* `mul_mod(a, b, q)`: the 128-bit product a b reduced by Barrett with
  floor(2^128 / q), word for word as `modular.barrett_reduce_128`.

Words are u64 bit patterns in int64 tensors [..., N]; the tables (w,
w_sh, b) broadcast against x or a. On a CUDA tensor each function
launches its kernel in `csrc/u64mod.cu`, which reads broadcast tables
through their strides, and counts the launch in `_build.LAUNCHES`
("shoup_mul_mod", "mul_mod"); on a CPU tensor it runs its plain twin
(`shoup_mul_mod_plain`, `mul_mod_plain`), the kernel's oracle on the
card. The reference's planar layout, a [..., 2, N] stack of u32 planes,
works around the TPU's lack of 64-bit lanes; the card has them, so the
planes stay at the API (`split64`, `join64`) and out of memory.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math.modular import M32, s64, srl
from sunscreen_tpu_torch.math.prns import _is_cpu

LEAD = 4   # leading dims the kernels read through strides (csrc/u64mod.cu)


def split64(x):
    """u64 words [..., N] -> (lo, hi) u32 planes, as int64 tensors."""
    return x & M32, srl(x, 32)


def join64(lo, hi):
    """(lo, hi) u32 planes -> u64 words [..., N]."""
    return (hi << 32) | lo


def shoup_mul_mod_plain(x, w, w_sh, q: int):
    """The twin of `_shoup_core`: hi64(x w_sh) estimates the quotient,
    lo64(w x) - lo64(hi q) lies in [0, 2q), one conditional subtract."""
    r = w * x - m.mul_hi(x, w_sh) * q
    return torch.where(m.uge(r, s64(q)), r - q, r)


def mul_mod_plain(a, b, q: int):
    """The twin of `_barrett128_core` on the product of `_mul64_128`."""
    r_hi, r_lo = m.barrett_ratio(q)
    hi, lo = m.mul_wide(a, b)
    return m.barrett_reduce_128(hi, lo, q, s64(r_hi), s64(r_lo))


def _layout(shape, *ops):
    """Host int64 tensors for the kernels: the LEAD leading sizes of
    `shape` (outermost first, padded with 1) and, per operand, its
    strides over them followed by its last-dim stride. Size-1 dims are
    dropped and neighbours merged where every operand allows it."""
    dims: list[list[int]] = []
    for d, size in enumerate(shape[:-1]):
        if size == 1:
            continue
        st = [v.stride(d) for v in ops]
        if dims and all(dims[-1][1 + i] == size * s
                        for i, s in enumerate(st)):
            dims[-1] = [dims[-1][0] * size, *st]
        else:
            dims.append([size, *st])
    if len(dims) > LEAD:
        raise ValueError(f"shape {tuple(shape)} has more than {LEAD} "
                         f"leading dims that do not merge")
    dims = [[1] + [0] * len(ops)] * (LEAD - len(dims)) + dims
    sizes = torch.tensor([d[0] for d in dims], dtype=torch.int64)
    strides = torch.tensor(
        [[d[1 + i] for d in dims] + [v.stride(-1)]
         for i, v in enumerate(ops)], dtype=torch.int64)
    return sizes, strides


def _operands(x, *tables):
    """x and its tables expanded (as views) to the broadcast shape."""
    try:
        shape = torch.broadcast_shapes(x.shape, *(t.shape for t in tables))
    except RuntimeError:
        shape = None
    if shape != x.shape:
        raise ValueError(f"tables {[tuple(t.shape) for t in tables]} do "
                         f"not broadcast to {tuple(x.shape)}")
    for v in (x, *tables):
        if v.device != x.device or v.dtype != torch.int64:
            raise ValueError(f"expected int64 on {x.device}, got "
                             f"{v.dtype} on {v.device}")
    return shape, [t.expand(shape) for t in (x, *tables)]


def shoup_mul_mod(x, w, w_sh, q: int):
    """x w mod q for u64 x [..., N] in [0, 2q) against broadcastable
    tables w < q and w_sh = floor(w 2^64 / q), q < 2^62 (B18)."""
    if _is_cpu(x):
        return shoup_mul_mod_plain(x, w, w_sh, q)
    shape, ops = _operands(x, w, w_sh)
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    n = shape[-1] if len(shape) else 1
    rows = out.numel() // max(n, 1)
    if rows and n:
        sizes, strides = _layout(shape, *ops)
        _build.launch("u64mod", "u64_shoup_mul_mod", *ops, out, sizes,
                      strides, rows, n, q)
        _build.LAUNCHES["shoup_mul_mod"] += 1
    return out


def mul_mod(a, b, q: int):
    """Exact a b mod q for u64 a [..., N] and broadcastable b, both
    in [0, q), q < 2^62 (B18)."""
    if _is_cpu(a):
        return mul_mod_plain(a, b, q)
    shape, ops = _operands(a, b)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = shape[-1] if len(shape) else 1
    rows = out.numel() // max(n, 1)
    if rows and n:
        r_hi, r_lo = m.barrett_ratio(q)
        sizes, strides = _layout(shape, *ops)
        _build.launch("u64mod", "u64_mul_mod", *ops, out, sizes, strides,
                      rows, n, q, r_hi, r_lo)
        _build.LAUNCHES["mul_mod"] += 1
    return out

"""Fused RNS conversions and pointwise passes: the port of
`sunscreen_tpu/math/prns.py`.

Six ops, each one pass over its input with the same residues as the
unfused `math/rns.py` code or the plain pointwise products:

* `FusedRnsOp` in mode "convert" (built by `fused_converter`): base
  conversion C -> D, optionally centered and with the source limbs
  copied ahead of the result (base extension) - kernel B6;
* `FusedRnsOp` in mode "scale" (built by `fused_scaler`): round(t x / Q)
  from the tensor base Q ∪ B into B - kernel B9;
* `FusedScaleConvert`: the same scale chained with the centered
  conversion B -> Q - kernel B7;
* `FusedModDown` (built by `fused_mod_down`): the special-prime rescale
  round(x / p) mod Q - kernel B8;
* `FusedTensor3`: the BFV tensor (a0 b0, a0 b1 + a1 b0, a1 b1) mod q of
  two NTT-domain operands - kernel B10;
* `FusedKsInner`: the keyswitch digit contraction against both key
  components - kernel B11.

On a CUDA tensor each op launches its kernel in `csrc/rns.cu` or
`csrc/pointwise.cu` and counts the launch in `_build.LAUNCHES`; on a CPU
tensor it runs its plain twin (`call_plain`), a composition of the plain
`math/rns.py` / `math/modular.py` code that also serves as the kernel's
oracle on the card. The tables are packed once, on the host, from the
port's own `RnsBase` / `BaseConverter` / `ScaleAndRound` / `ModDown`
objects and uploaded to their device.
"""

from __future__ import annotations

import math

import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math.modular import U32_MAX_MODULUS_BITS

MAX_LIMBS = 64       # the scale kernels' source base (csrc/rns.cu MAXK)
MAX_CONVERT_LIMBS = 32   # rns_convert's bases, B of both scale kernels
MAX_KS_DIGITS = 32   # FusedKsInner digits (its sums fold every 16 terms)


def _table(base, *cols) -> torch.Tensor:
    """[k, 8] int64 per modulus of `base`: q, floor(2^64 / q) (below 2^63
    for q > 2), then the given [k, 1] columns, zero-padded. The kernels
    hold the u32 engine only (every modulus below 2^30), as the
    reference's do."""
    if max(q.bit_length() for q in base.moduli) > U32_MAX_MODULUS_BITS:
        raise ValueError("the fused RNS kernels take moduli below 2^30 "
                         "only (the u64 engine runs the plain glue)")
    m = torch.tensor([(1 << 64) // q for q in base.moduli],
                     dtype=torch.int64, device=base.device).reshape(-1, 1)
    out = torch.cat([base.q, m, *(c.to(base.device) for c in cols)], dim=1)
    return torch.nn.functional.pad(out, (0, 8 - out.shape[1]))


def _is_cpu(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(x, device, tail, dtype=torch.int64) -> int:
    """Validates a kernel input; returns its row count."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"expected {dtype} on {device}, got {x.dtype} on "
                         f"{x.device}")
    if tuple(x.shape[x.dim() - len(tail):]) != tuple(tail):
        raise ValueError(f"expected trailing shape {tuple(tail)}, got "
                         f"{tuple(x.shape)}")
    rows = 1
    for d in x.shape[:x.dim() - len(tail)]:
        rows *= d
    return rows


def _limbs_ok(limit: int, *ks) -> None:
    if max(ks) > limit:
        raise ValueError(f"the fused RNS kernels hold at most {limit} "
                         f"limbs in this base, got {max(ks)}")


def _strided_rows(x, inner_dims: int):
    """x whose trailing `inner_dims` dims form one contiguous block ->
    (x, row stride in elements), the leading dims merged into evenly
    strided rows. Copies only when no such stride exists: the
    keyswitch's `both[..., :k, :]` view is read in place."""
    lead = x.dim() - inner_dims
    block = math.prod(x.shape[lead:])
    dense = all(x.stride(d) == math.prod(x.shape[d + 1:])
                for d in range(lead, x.dim()) if x.shape[d] > 1)
    outer = [(x.shape[d], x.stride(d)) for d in range(lead)
             if x.shape[d] > 1]
    even = all(s0 == n1 * s1 for (_, s0), (n1, s1) in zip(outer, outer[1:]))
    if not (dense and even):
        return x.contiguous(), block
    return x, outer[-1][1] if outer else block


class FusedRnsOp:
    """One conversion between two bases in one pass: mode "convert" is
    the base conversion C -> D of a `rns.BaseConverter`; mode "scale" is
    `rns.ScaleAndRound.apply`, round(t x / Q) from its source base into
    its target base (the reference's modes of the same op)."""

    def __init__(self, op, mode: str):
        assert mode in ("convert", "scale"), mode
        src, dst = op.src, op.dst
        self.op, self.mode = op, mode
        self.ks, self.kd = src.k, dst.k
        self.device = dst.device
        if mode == "convert":
            self.src_tab = _table(src, src.inv_punc, src.inv_q_fp_hi,
                                  src.inv_q_fp_lo)
            self.dst_tab = _table(dst, op.c_mod_d)
            mat = op.theta
        else:
            self.src_tab = _table(src, src.inv_punc, op.phi_hi, op.phi_lo)
            self.dst_tab = _table(dst)
            mat = op.omega
        self.mat = mat.reshape(self.ks, self.kd).contiguous()

    def call_plain(self, x, include_src: bool = False, centered: bool = True):
        if self.mode == "scale":
            return self.op.apply_plain(x)
        out = self.op.convert_plain(x, centered=centered)
        return torch.cat([x, out], dim=-2) if include_src else out

    def __call__(self, x, include_src: bool = False, centered: bool = True):
        """x [..., ks, N] -> [..., kd, N]. Mode "convert": include_src ->
        [..., ks+kd, N] with the source limbs first (base extension, no
        concat pass). Mode "scale" always rounds and takes neither
        option."""
        if self.mode == "scale" and include_src:
            raise ValueError('mode "scale" has no include_src')
        if _is_cpu(x):
            return self.call_plain(x, include_src, centered)
        n = x.shape[-1]
        rows = _check(x, self.device, (self.ks, n))
        if self.mode == "convert":
            _limbs_ok(MAX_CONVERT_LIMBS, self.ks, self.kd)
        else:
            _limbs_ok(MAX_LIMBS, self.ks)
            _limbs_ok(MAX_CONVERT_LIMBS, self.kd)
        x = x.contiguous()
        ko = self.ks + self.kd if include_src else self.kd
        out = torch.empty(*x.shape[:-2], ko, n, dtype=torch.int64,
                          device=x.device)
        if rows and self.mode == "scale":
            _build.launch("rns", "rns_scale", x, out, self.src_tab,
                          self.dst_tab, self.mat, rows, self.ks, self.kd, n)
            _build.LAUNCHES["scale"] += 1
        elif rows:
            _build.launch("rns", "rns_convert", x, out, self.src_tab,
                          self.dst_tab, self.mat, rows, self.ks, self.kd,
                          n, int(centered), int(include_src))
            _build.LAUNCHES["convert"] += 1
        return out


class FusedScaleConvert:
    """`ScaleAndRound.apply` (base Q∪B -> B) chained with the centered
    `BaseConverter.convert` (B -> Q) in one pass: out = [round(t x/Q)]_Q
    for x in the tensor base; the scaled-aux intermediate never exists
    in device memory."""

    def __init__(self, sc, conv):
        assert sc.dst.moduli == conv.src.moduli
        self.sc, self.conv = sc, conv
        self.ks, self.km, self.kd = sc.src.k, sc.dst.k, conv.dst.k
        self.device = conv.dst.device
        b = conv.src
        self.a_tab = _table(sc.src, sc.src.inv_punc, sc.phi_hi, sc.phi_lo)
        self.b_tab = _table(b, b.inv_punc, b.inv_q_fp_hi, b.inv_q_fp_lo)
        self.d_tab = _table(conv.dst, conv.c_mod_d)
        self.omega = sc.omega.reshape(self.ks, self.km).contiguous()
        self.theta = conv.theta.reshape(self.km, self.kd).contiguous()

    def call_plain(self, x):
        return self.conv.convert_plain(self.sc.apply_plain(x), centered=True)

    def __call__(self, x):
        """x [..., ks, N] (tensor base Q∪B) -> [..., kd, N] (base Q)."""
        if _is_cpu(x):
            return self.call_plain(x)
        n = x.shape[-1]
        rows = _check(x, self.device, (self.ks, n))
        _limbs_ok(MAX_LIMBS, self.ks)
        _limbs_ok(MAX_CONVERT_LIMBS, self.km)
        x = x.contiguous()
        out = torch.empty(*x.shape[:-2], self.kd, n, dtype=torch.int64,
                          device=x.device)
        if rows:
            _build.launch("rns", "scale_convert", x, out, self.a_tab,
                          self.b_tab, self.d_tab, self.omega, self.theta,
                          rows, self.ks, self.km, self.kd, n)
            _build.LAUNCHES["scale_convert"] += 1
        return out


class FusedModDown:
    """One-pass special-prime rescale of a `rns.ModDown`:
    v = (x_p + p/2) mod p; out_j = (x_j + (p/2 mod q_j) - v) p^-1 mod q_j."""

    def __init__(self, md):
        qb = md.q_base
        self.md = md
        self.k = qb.k
        self.device = qb.device
        self.p, self.half = int(md.p), int(md.half)
        if self.p >= 1 << U32_MAX_MODULUS_BITS:
            raise ValueError("FusedModDown takes p below 2^30 only")
        self.tab = _table(qb, md.half_mod_q, md.inv_p)

    def call_plain(self, x_q, x_p):
        return self.md.apply_plain(x_q, x_p)

    def __call__(self, x_q, x_p):
        """x_q [..., k, N], x_p [..., N] -> [..., k, N]. Both may be
        strided views of one tensor (the keyswitch passes the limbs and
        the special limb of its [..., 2, k+1, N] output): each is read
        in place wherever its rows are evenly strided."""
        if _is_cpu(x_q):
            return self.call_plain(x_q, x_p)
        n = x_q.shape[-1]
        rows = _check(x_q, self.device, (self.k, n))
        if _check(x_p, self.device, (n,)) != rows:
            raise ValueError(f"x_q {tuple(x_q.shape)} and x_p "
                             f"{tuple(x_p.shape)} differ in rows")
        xq, sq = _strided_rows(x_q, 2)
        xp, sp = _strided_rows(x_p, 1)
        out = torch.empty(*x_q.shape[:-2], self.k, n, dtype=torch.int64,
                          device=x_q.device)
        if rows:
            _build.launch("rns", "mod_down", xq, xp, out, self.tab, rows,
                          self.k, n, sq, sp, self.p, self.half)
            _build.LAUNCHES["mod_down"] += 1
        return out


class FusedTensor3:
    """The BFV tensor of two 2-component NTT-domain operands in one
    pass: (a0 b0, a0 b1 + a1 b0, a1 b1) mod q per limb of `base` (the
    component loop of `bfv.ops.multiply`)."""

    def __init__(self, base):
        self.k = base.k
        self.q = base.q
        self.device = base.device
        self.tab = _table(base)

    def call_plain(self, a, b):
        return m.tensor3_mod(a, b, self.q)

    def __call__(self, a, b):
        """a, b [..., 2, k, N] (values < q) -> [..., 3, k, N]. Either may
        be a strided view (the halves of one [..., 4, k, N] stack): evenly
        strided rows are read in place."""
        if _is_cpu(a):
            return self.call_plain(a, b)
        n = a.shape[-1]
        tail = (2, self.k, n)
        rows = _check(a, self.device, tail)
        if a.shape != b.shape:
            raise ValueError(f"operands differ in shape: {tuple(a.shape)} "
                             f"vs {tuple(b.shape)}")
        _check(b, self.device, tail)
        ar, sa = _strided_rows(a, 3)
        br, sb = _strided_rows(b, 3)
        out = torch.empty(*a.shape[:-3], 3, self.k, n, dtype=torch.int64,
                          device=a.device)
        if rows:
            _build.launch("pointwise", "tensor3_pointwise", ar, br, out,
                          self.tab, rows, self.k, n, sa, sb)
            _build.LAUNCHES["tensor3"] += 1
        return out


class FusedKsInner:
    """The keyswitch inner products in one pass: for both key components
    c, sum_i d_hat[i] key_c[i] mod q per limb of `base` (the digit-axis
    contraction of `bfv.ops.keyswitch`, without the inverse transform)."""

    def __init__(self, base):
        self.kk = base.k
        self.q = base.q
        self.device = base.device
        self.tab = _table(base)

    def call_plain(self, d_hat, k0, k1):
        return m.ks_inner_mod(d_hat, k0, k1, self.q)

    def __call__(self, d_hat, k0, k1):
        """d_hat [..., kdig, kk, N], keys k0/k1 [kdig, kk, N] (values < q)
        -> [..., 2, kk, N], both key components stacked in one output."""
        if _is_cpu(d_hat):
            return self.call_plain(d_hat, k0, k1)
        kdig, n = d_hat.shape[-3], d_hat.shape[-1]
        if kdig > MAX_KS_DIGITS:
            raise ValueError(f"FusedKsInner holds at most {MAX_KS_DIGITS} "
                             f"digits, got {kdig}")
        tail = (kdig, self.kk, n)
        rows = _check(d_hat, self.device, tail)
        for key in (k0, k1):
            if _check(key, self.device, tail) != 1 or key.dim() != 3:
                raise ValueError("keys must be [kdig, kk, N]")
        out = torch.empty(*d_hat.shape[:-3], 2, self.kk, n,
                          dtype=torch.int64, device=d_hat.device)
        if rows:
            _build.launch("pointwise", "ks_inner", d_hat.contiguous(),
                          k0.contiguous(), k1.contiguous(), out, self.tab,
                          rows, kdig, self.kk, n)
            _build.LAUNCHES["ks_inner"] += 1
        return out


def fused_converter(conv) -> FusedRnsOp:
    """The fused op of a `rns.BaseConverter`."""
    return FusedRnsOp(conv, "convert")


def fused_scaler(sc) -> FusedRnsOp:
    """The fused op of a `rns.ScaleAndRound`."""
    return FusedRnsOp(sc, "scale")


def fused_mod_down(md) -> FusedModDown:
    """The fused op of a `rns.ModDown`."""
    return FusedModDown(md)

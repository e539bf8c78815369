"""RNS machinery: base conversion and scaling, on int64 torch tensors.

Port of `sunscreen_tpu/math/rns.py`: HPS-style conversions whose
correction term alpha comes from an exact 128-bit fixed-point sum built
from 32-bit column sums. As in the reference's `_fused()` hooks, a CUDA
tensor goes to the fused kernels of `math/prns.py`:
`BaseConverter.extend` / `.convert` to B6, `ScaleAndRound.apply` to B9
and `ModDown.apply` to B8, each op built once per object and cached. On
the CPU they run the plain code (`convert_plain`, `apply_plain`), which
is also the kernels' oracle. The default multiply reaches the scale
through the chained B7 instead (`bfv/ops.py::_scale_convert`); B9 runs
under `SUNSCREEN_TPU_FUSE_SC=0`. The plain residue products are below
2^60, so they are taken exactly in int64 and reduced with `%`; the
results are the same residues the reference computes.

Layouts: polynomials are [..., k, N], limb-major.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import prns
from sunscreen_tpu_torch.math.modular import M32, s64, srl


def _col(values, device) -> torch.Tensor:
    """Python ints -> int64 column [k, 1] (u64 values as bit patterns)."""
    return torch.tensor([s64(int(v)) for v in values], dtype=torch.int64,
                        device=device).reshape(-1, 1)


class RnsBase:
    """A set of coprime moduli plus the host and device tables every
    conversion needs (SEAL's `util::RNSBase`)."""

    def __init__(self, moduli: tuple[int, ...], device):
        assert len(set(moduli)) == len(moduli), "moduli must be distinct"
        self.moduli = tuple(int(q) for q in moduli)
        self.k = len(self.moduli)
        self.product = 1
        for q in self.moduli:
            self.product *= q
        self.punctured = [self.product // q for q in self.moduli]
        self.inv_punctured = [pow(p % q, -1, q)
                              for p, q in zip(self.punctured, self.moduli)]
        self.q = _col(self.moduli, device)                   # [k, 1]
        self.device = self.q.device
        self.inv_punc = _col(self.inv_punctured, device)
        # 1/q_i as 128 fractional bits, rounded UP (the reference's
        # one-sided convention: tiny negative centered values convert as
        # their centered lift)
        fr = [((1 << 128) + q - 1) // q for q in self.moduli]
        self.inv_q_fp_hi = _col([v >> 64 for v in fr], device)
        self.inv_q_fp_lo = _col([v for v in fr], device)
        # floor(2^128 / q) for the Barrett reductions of full u64 words
        ratios = [m.barrett_ratio(q) for q in self.moduli]
        self.ratio_hi = _col([r[0] for r in ratios], device)
        self.ratio_lo = _col([r[1] for r in ratios], device)
        self.wide = max(q.bit_length() for q in self.moduli) > 31

    def reduce_u64(self, x):
        """Full u64 words [..., N] -> residues [..., k, N]."""
        return m.barrett_reduce_64(x.unsqueeze(-2), self.q, self.ratio_hi,
                                   self.ratio_lo)

    def normalize_digits(self, x):
        """y_i = [x_i * (C/c_i)^{-1}]_{c_i} for x of shape [..., k, N]:
        an int64 product below 2^62 for moduli under 2^31, else the
        128-bit product and Barrett reduction of `modular.mul_mod`."""
        if self.wide:
            return m.mul_mod(x, self.inv_punc, self.q, self.ratio_hi,
                             self.ratio_lo)
        return x * self.inv_punc % self.q


def fixed_point_dot(y, phi_hi, phi_lo, add_half: bool):
    """Exact fixed-point inner product over the limb axis (-2).

    S = sum_i y[..., i, :] * phi_i with phi_i = (phi_hi_i 2^64 +
    phi_lo_i) / 2^128 in [0, 1); phi_* are [k, 1] int64 bit patterns.
    Returns ((int_hi, int_lo), (frac_hi, frac_lo)): the 128-bit integer
    part of S (+ 1/2 if add_half) and the 128 fractional bits before the
    half was added, each word a u64 bit pattern. Same column-sum
    algorithm, hence the same bits, as the reference.
    """
    h0, l0 = m.mul_wide(y, phi_lo)   # worth 2^0 (in 2^-128 units)
    h1, l1 = m.mul_wide(y, phi_hi)   # worth 2^64
    c0 = (l0 & M32).sum(-2)
    c1 = srl(l0, 32).sum(-2)
    c2 = ((h0 & M32) + (l1 & M32)).sum(-2)
    c3 = (srl(h0, 32) + srl(l1, 32)).sum(-2)
    c4 = (h1 & M32).sum(-2)
    c5 = srl(h1, 32).sum(-2)
    t0 = c0
    t1 = c1 + (t0 >> 32)
    t2 = c2 + (t1 >> 32)
    t3 = c3 + (t2 >> 32)
    frac_lo = (t0 & M32) | ((t1 & M32) << 32)
    frac_hi = (t2 & M32) | ((t3 & M32) << 32)
    if add_half:
        t3 = t3 + (1 << 31)
    t4 = c4 + (t3 >> 32)
    t5 = c5 + (t4 >> 32)
    int_lo = (t4 & M32) | ((t5 & M32) << 32)
    int_hi = t5 >> 32
    return (int_hi, int_lo), (frac_hi, frac_lo)


def _dot_mod(y, table, d):
    """sum_i y[..., i, :] * table[i, j] mod d_j -> [..., kd, N]; y < 2^30,
    table [ks, kd, 1] < d < 2^30, d [kd, 1]. Accumulates over source
    limbs so no [.., ks, kd, N] stack is formed."""
    acc = None
    for i in range(y.shape[-2]):
        term = y[..., i:i + 1, :] * table[i] % d
        acc = term if acc is None else acc + term
    return acc % d


class BaseConverter:
    """Fast base conversion C -> D with exact fixed-point alpha
    correction; `centered=True` converts the centered representative
    in (-C/2, C/2]."""

    def __init__(self, src: RnsBase, dst: RnsBase):
        self.src, self.dst = src, dst
        dev = dst.device
        self.theta = torch.tensor(
            [[src.punctured[i] % d for d in dst.moduli]
             for i in range(src.k)], dtype=torch.int64,
            device=dev).unsqueeze(-1)                        # [ks, kd, 1]
        self.c_mod_d = _col([src.product % d for d in dst.moduli], dev)
        self._fused_op = None

    def _fused(self) -> prns.FusedRnsOp:
        if self._fused_op is None:
            self._fused_op = prns.fused_converter(self)
        return self._fused_op

    def extend(self, x, centered: bool = True):
        """[..., k_src, N] -> [..., k_src + k_dst, N]: the source limbs
        followed by the converted ones (one kernel pass on CUDA)."""
        return self._fused()(x, include_src=True, centered=centered)

    def convert(self, x, centered: bool = False):
        """[..., k_src, N] -> [..., k_dst, N]."""
        return self._fused()(x, centered=centered)

    def convert_plain(self, x, centered: bool = False):
        src, dst = self.src, self.dst
        y = src.normalize_digits(x)
        (_, alpha), _ = fixed_point_dot(
            y, src.inv_q_fp_hi, src.inv_q_fp_lo, add_half=centered)
        acc = _dot_mod(y, self.theta, dst.q)
        corr = alpha.unsqueeze(-2) * self.c_mod_d % dst.q   # alpha < k_src
        return m.sub_mod(acc, corr, dst.q)


class ScaleAndRound:
    """[round(t * x / Q)]_{d_j} for x in base C (Q | C) and every d_j
    dividing C/Q — the HPS multiply's scale into the aux base."""

    def __init__(self, src: RnsBase, q_base: RnsBase, dst: RnsBase, t: int):
        assert src.product % q_base.product == 0
        p_prime = src.product // q_base.product
        for d in dst.moduli:
            assert p_prime % d == 0, "target modulus must divide C/Q"
        Q = q_base.product
        omega, fr = [], []
        for i in range(src.k):
            num = t * src.punctured[i]
            omega.append([(num // Q) % d for d in dst.moduli])
            fr.append(((num % Q) << 128) // Q)
        dev = dst.device
        self.src, self.dst = src, dst
        self.omega = torch.tensor(omega, dtype=torch.int64,
                                  device=dev).unsqueeze(-1)  # [ks, kd, 1]
        self.phi_hi = _col([v >> 64 for v in fr], dev)
        self.phi_lo = _col(fr, dev)
        self._fused_op = None

    def apply(self, x):
        """[..., k_src, N] -> [..., k_dst, N] = [round(t*x/Q)]_D (one
        kernel pass on CUDA)."""
        if self._fused_op is None:
            self._fused_op = prns.fused_scaler(self)
        return self._fused_op(x)

    def apply_plain(self, x):
        y = self.src.normalize_digits(x)
        (_, r_lo), _ = fixed_point_dot(y, self.phi_hi, self.phi_lo,
                                       add_half=True)
        acc = _dot_mod(y, self.omega, self.dst.q)
        # r < k_src * 2^30: one word, and nonnegative as an int64
        return m.add_mod(acc, r_lo.unsqueeze(-2) % self.dst.q, self.dst.q)


class DecryptScaler:
    """[round(t * x / Q)]_t from x in base Q, plus the 128 fractional
    bits that measure the invariant noise."""

    def __init__(self, q_base: RnsBase, t: int):
        self.q_base = q_base
        self.t = t
        k, Q = q_base.k, q_base.product
        omega, fr = [], []
        for i in range(k):
            num = t * q_base.punctured[i]
            omega.append((num // Q) % t)
            fr.append(((num % Q) << 128) // Q)
        dev = q_base.device
        self.omega = _col(omega, dev)
        self.phi_hi = _col([v >> 64 for v in fr], dev)
        self.phi_lo = _col(fr, dev)
        rh, rl = m.barrett_ratio(t)
        self.t_ratio = (s64(rh), s64(rl))

    def apply(self, x):
        """[..., k, N] -> ([..., N] result mod t, (frac_hi, frac_lo))."""
        qb = self.q_base
        y = qb.normalize_digits(x)
        (r_hi, r_lo), frac = fixed_point_dot(y, self.phi_hi, self.phi_lo,
                                             add_half=True)
        t = self.t
        rh, rl = self.t_ratio
        acc = ((y % t) * self.omega % t).sum(-2) % t
        r_hi_red = m.barrett_reduce_64(r_hi, t, rh, rl)
        r = m.barrett_reduce_128(r_hi_red, r_lo, t, rh, rl)
        return m.add_mod(acc, r, t), frac


class ModDown:
    """round(x / p) mod Q for x in base Q ∪ {p}: the special-prime
    rescale at the end of hybrid keyswitching."""

    def __init__(self, q_base: RnsBase, p: int):
        self.q_base = q_base
        self.p = p
        self.half = p >> 1
        dev = q_base.device
        self.inv_p = _col([pow(p % q, -1, q) for q in q_base.moduli], dev)
        self.half_mod_q = _col([self.half % q for q in q_base.moduli], dev)
        self._fused_op = None

    def apply(self, x_q, x_p):
        """x_q: [..., k, N], x_p: [..., N] -> [..., k, N] (one kernel
        pass on CUDA, reading strided views in place)."""
        if self._fused_op is None:
            self._fused_op = prns.fused_mod_down(self)
        return self._fused_op(x_q, x_p)

    def apply_plain(self, x_q, x_p):
        q = self.q_base.q
        xp = m.add_mod(x_p, self.half, self.p).unsqueeze(-2) % q
        num = m.sub_mod(m.add_mod(x_q, self.half_mod_q, q), xp, q)
        return num * self.inv_p % q

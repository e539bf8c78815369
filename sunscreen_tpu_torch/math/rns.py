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
under `SUNSCREEN_TPU_FUSE_SC=0`. The fused kernels hold the u32 engine
only, as the reference's do (`rns.py:222`, `:315`, `:438`): a base with
a modulus above 2^30 (the u64 engine, limbs up to 56 bits) runs the
plain code on every device. On the u32 engine the plain residue products
are below 2^60, so they are taken exactly in int64 and reduced with `%`;
on the u64 engine they go through Shoup multiplies with precomputed
ratios (`modular.w_shoup_mul`) or the 128-bit Barrett product. The
results are the same residues the reference computes.

Layouts: polynomials are [..., k, N], limb-major.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import prns
from sunscreen_tpu_torch.math.modular import M32, U64, s64, srl


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
        # engine word: U32 iff every modulus < 2^30 (the fused kernels'
        # domain); the u64 engine's Shoup ratios of the digit inverses
        self.word = m.word_dtype_for(self.moduli)
        self.inv_punc_sh = _col([m.shoup_ratio(v, q) for v, q in
                                 zip(self.inv_punctured, self.moduli)],
                                device)
        # the (c0, c1) reduction constants of `modular.w_reduce` per limb
        consts = [m.w_consts_host(q, self.word) for q in self.moduli]
        self.c0 = _col([c[0] for c in consts], device)
        self.c1 = _col([c[1] for c in consts], device)

    @property
    def u64(self) -> bool:
        return self.word == U64

    # -- host-side exact CRT (tests, key material, encodings) ---------------

    def compose(self, residues) -> list[int]:
        """CRT-compose [k, N] residues below their moduli (a tensor or
        array) to N Python ints in [0, product)."""
        if isinstance(residues, torch.Tensor):
            residues = residues.cpu().numpy()
        arr = np.asarray(residues).astype(np.int64).astype(object)
        assert arr.shape[0] == self.k
        lifts = np.array([p * i % self.product for p, i in
                          zip(self.punctured, self.inv_punctured)],
                         dtype=object)
        return ((arr * lifts[:, None]).sum(axis=0) % self.product).tolist()

    def decompose(self, values) -> np.ndarray:
        """N Python ints -> [k, N] uint64 residues (the reference's
        dtype)."""
        vals = [int(v) % self.product for v in values]
        out = np.empty((self.k, len(vals)), dtype=np.uint64)
        for i, q in enumerate(self.moduli):
            out[i] = np.array([v % q for v in vals], dtype=np.uint64)
        return out

    def mul(self, a, b):
        """Exact (a b) mod q per limb for residues a, b [..., k, N]."""
        if self.u64:
            return m.mul_mod(a, b, self.q, self.ratio_hi, self.ratio_lo)
        return a * b % self.q

    def reduce_u64(self, x):
        """Full u64 words [..., N] -> residues [..., k, N]."""
        return m.barrett_reduce_64(x.unsqueeze(-2), self.q, self.ratio_hi,
                                   self.ratio_lo)

    def normalize_digits(self, x):
        """y_i = [x_i * (C/c_i)^{-1}]_{c_i} for x of shape [..., k, N]:
        an int64 product below 2^60 on the u32 engine, else a Shoup
        multiply with the precomputed ratios (any u64 x, q < 2^62)."""
        if self.u64:
            return m.reduce_2q(m.mul_mod_shoup(x, self.inv_punc,
                                               self.inv_punc_sh, self.q),
                               self.q)
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


def _dot_mod(y, table, d, table_sh=None):
    """sum_i y[..., i, :] * table[i, j] mod d_j -> [..., kd, N], d [kd, 1],
    table [ks, kd, 1] < d. u32 engine (table_sh None): y, d < 2^30, exact
    int64 products. u64 engine: y < 2^56 and the Shoup ratios table_sh of
    the table; each term is reduced to [0, d), and the raw sum of
    ks < 2^7 terms below 2^56 cannot wrap. Accumulates over source limbs
    so no [.., ks, kd, N] stack is formed."""
    acc = None
    for i in range(y.shape[-2]):
        yi = y[..., i:i + 1, :]
        if table_sh is None:
            term = yi * table[i] % d
        else:
            term = m.reduce_2q(m.mul_mod_shoup(yi, table[i], table_sh[i], d),
                               d)
        acc = term if acc is None else acc + term
    return acc % d


def _sh(table, d_moduli, device):
    """Shoup ratios [ks, kd, 1] of a table [ks, kd, 1] against d."""
    return torch.tensor(
        [[s64(m.shoup_ratio(int(v), d)) for v, d in zip(row, d_moduli)]
         for row in table[..., 0].tolist()], dtype=torch.int64,
        device=device).unsqueeze(-1)


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
        self.u64 = src.u64 or dst.u64
        self.theta_sh = _sh(self.theta, dst.moduli, dev) if self.u64 \
            else None
        self._fused_op = None

    def _fused(self) -> prns.FusedRnsOp:
        if self._fused_op is None:
            self._fused_op = prns.fused_converter(self)
        return self._fused_op

    def extend(self, x, centered: bool = True):
        """[..., k_src, N] -> [..., k_src + k_dst, N]: the source limbs
        followed by the converted ones (one kernel pass on CUDA, u32
        engine)."""
        if self.u64:
            return torch.cat([x, self.convert_plain(x, centered)], dim=-2)
        return self._fused()(x, include_src=True, centered=centered)

    def convert(self, x, centered: bool = False):
        """[..., k_src, N] -> [..., k_dst, N]."""
        if self.u64:
            return self.convert_plain(x, centered)
        return self._fused()(x, centered=centered)

    def convert_plain(self, x, centered: bool = False):
        src, dst = self.src, self.dst
        y = src.normalize_digits(x)
        (_, alpha), _ = fixed_point_dot(
            y, src.inv_q_fp_hi, src.inv_q_fp_lo, add_half=centered)
        acc = _dot_mod(y, self.theta, dst.q, self.theta_sh)
        # alpha < k_src and c_mod_d < 2^56: an exact int64 product
        corr = alpha.unsqueeze(-2) * self.c_mod_d % dst.q
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
        self.u64 = src.u64 or dst.u64
        self.omega_sh = _sh(self.omega, dst.moduli, dev) if self.u64 \
            else None
        self._fused_op = None

    def apply(self, x):
        """[..., k_src, N] -> [..., k_dst, N] = [round(t*x/Q)]_D (one
        kernel pass on CUDA, u32 engine)."""
        if self.u64:
            return self.apply_plain(x)
        if self._fused_op is None:
            self._fused_op = prns.fused_scaler(self)
        return self._fused_op(x)

    def apply_plain(self, x):
        y = self.src.normalize_digits(x)
        (_, r_lo), _ = fixed_point_dot(y, self.phi_hi, self.phi_lo,
                                       add_half=True)
        acc = _dot_mod(y, self.omega, self.dst.q, self.omega_sh)
        # r < k_src 2^56 < 2^63: one word, and nonnegative as an int64
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
        inv_p = [pow(p % q, -1, q) for q in q_base.moduli]
        self.inv_p = _col(inv_p, dev)
        self.half_mod_q = _col([self.half % q for q in q_base.moduli], dev)
        # the reference's fused kernel takes the u32 engine and p < 2^30
        self.u64 = q_base.u64 or p >= 1 << 30
        self.inv_p_sh = _col([m.shoup_ratio(v, q) for v, q in
                              zip(inv_p, q_base.moduli)], dev)
        self._fused_op = None

    def apply(self, x_q, x_p):
        """x_q: [..., k, N], x_p: [..., N] -> [..., k, N] (one kernel
        pass on CUDA, u32 engine, reading strided views in place)."""
        if self.u64:
            return self.apply_plain(x_q, x_p)
        if self._fused_op is None:
            self._fused_op = prns.fused_mod_down(self)
        return self._fused_op(x_q, x_p)

    def apply_plain(self, x_q, x_p):
        q = self.q_base.q
        xp = m.add_mod(x_p, self.half, self.p).unsqueeze(-2) % q
        num = m.sub_mod(m.add_mod(x_q, self.half_mod_q, q), xp, q)
        if self.u64:
            return m.reduce_2q(m.mul_mod_shoup(num, self.inv_p,
                                               self.inv_p_sh, q), q)
        return num * self.inv_p % q


@lru_cache(maxsize=64)
def _base_cached(moduli: tuple[int, ...], device) -> RnsBase:
    return RnsBase(moduli, device)


def get_base(moduli: tuple[int, ...], device=None) -> RnsBase:
    """Shared cache of bases; `device` None means CUDA."""
    return _base_cached(tuple(int(q) for q in moduli),
                        resolve_device(device))

"""Exact negacyclic torus-polynomial products via CRT NTT (port of
`sunscreen_tpu/tfhe/poly.py`).

Small signed digits, or full torus words, times torus polynomials mod
2^64, through an NTT over a few primes and an exact fixed-point
reconstruction back to Z / 2^64:

* `TorusNttPlan`: k = 2 (external products, keyswitches) or k = 3 (full
  torus x torus products: the GLWE mask . key dot) 62-bit primes on the
  plain u64 `math.ntt.NttPlan`;
* `TorusNttPlanU32`: four 30-bit primes on the u32 plan, whose forward
  transform (B1), digit contraction fused into the inverse (B5) and
  keyswitch megakernel (B15) are CUDA kernels on the card. The NTT-domain
  bootstrap key lives in its domain. Its `br_glue` is the rest of a
  blind-rotation step, one kernel on the card (`csrc/br_glue.cu`): the
  step's update back to the torus and the wrapping add, then the next
  step's rotated gadget digits as residues.

Plans are cached per (N, k, device).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from sunscreen_tpu_torch import _build, resolve_device
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import ntt, primes, rns
from sunscreen_tpu_torch.math.modular import s64, srl
from sunscreen_tpu_torch.math.sampling import signed_to_rns
from sunscreen_tpu_torch.tfhe import torus

# br_glue's kernel: N as B1's; a digit below the 30-bit primes
GLUE_MIN_N, GLUE_MAX_N = 256, 16384
GLUE_MAX_RADIX_LOG = 29


class TorusNttPlan:
    """Negacyclic multiply of signed-int or torus polys by torus polys,
    exact mod 2^64 for centered products |X| < C/2."""

    def __init__(self, n: int, k: int, device):
        self.n = n
        mods = tuple(primes.gen_ntt_primes(62, k, n))
        self.base = rns.RnsBase(mods, device)
        self.device = self.base.device
        self.plan = ntt.get_plan_u64(n, mods, self.device)
        # (C / c_i) mod 2^64 and C mod 2^64 for the wrapping reconstruction
        self.theta = rns._col(self.base.punctured, self.device)
        self.c_mod = s64(self.base.product)

    def torus_to_rns(self, t):
        """u64 torus [..., N] -> [..., k, N] residues."""
        return self.base.reduce_u64(t)

    def signed_to_rns(self, d):
        """signed int64 digits [..., N] -> [..., k, N] residues."""
        return signed_to_rns(d, self.base.q)

    def fwd(self, x_rns):
        return self.plan.fwd(x_rns)

    def pointwise(self, a, b):
        return self.plan.pointwise_mul(a, b)

    def add(self, a, b):
        return m.add_mod(a, b, self.base.q)

    def to_torus(self, x_rns):
        """[..., k, N] residues of a centered value |X| < C/2 -> exact
        torus words: sum_i y_i (C/c_i) - alpha C mod 2^64, alpha from the
        exact 128-bit fixed-point sum of y_i / c_i."""
        y = self.base.normalize_digits(x_rns)
        (_, alpha), _ = rns.fixed_point_dot(
            y, self.base.inv_q_fp_hi, self.base.inv_q_fp_lo, add_half=True)
        total = (y * self.theta).sum(-2)          # wraps mod 2^64
        return total - alpha * self.c_mod

    def negacyclic_mul_signed_torus(self, digits, torus_poly):
        """Exact negacyclic (digits * torus_poly) mod 2^64; digits int64
        [..., N] small, torus_poly [..., N] torus words."""
        a = self.fwd(self.signed_to_rns(digits))
        b = self.fwd(self.torus_to_rns(torus_poly))
        return self.to_torus(self.plan.inv(self.pointwise(a, b)))


class TorusNttPlanU32:
    """Four 30-bit CRT primes on the u32 plan (C > 2^116): centered
    products with |X| < C/2 (1 - 2^-27) reconstruct exactly mod 2^64;
    external products at the production configurations stay below 2^98.
    The wrap count alpha = floor(sum y_i / c_i + 1/2) comes from a 60-bit
    one-sided fixed point (g_i = ceil(2^60 / c_i))."""

    def __init__(self, n: int, k: int, device):
        mods = tuple(primes.gen_ntt_primes(30, k, n))
        self.n = n
        self.base = rns.RnsBase(mods, device)
        self.device = self.base.device
        # the reference pins PallasMatmulNttPlan whatever SUNSCREEN_TPU_NTT
        self.plan = ntt.get_plan(n, mods, self.device, "pallas")
        self.theta = rns._col(self.base.punctured, self.device)
        self.c_mod = s64(self.base.product)
        self.g60 = rns._col([((1 << 60) + q - 1) // q for q in mods],
                            self.device)
        # br_glue's table, a row of 8 per prime: q, floor(2^64 / q),
        # (C/q)^-1 mod q, g, C/q mod 2^64, C mod 2^64
        self.glue_tab = torch.tensor(
            [[q, (1 << 64) // q, inv, ((1 << 60) + q - 1) // q, s64(punc),
              self.c_mod, 0, 0]
             for q, inv, punc in zip(mods, self.base.inv_punctured,
                                     self.base.punctured)],
            dtype=torch.int64, device=self.device)

    def torus_to_rns(self, t):
        """u64 torus [..., N] -> [..., k, N] residues."""
        return self.base.reduce_u64(t)

    def signed_to_rns(self, d):
        return signed_to_rns(d, self.base.q)

    def fwd(self, x_rns):
        """Forward transform into the flat NTT domain (B1 on the card)."""
        return self.plan.fwd(x_rns)

    def contract_inv(self, d_hat, k0, k1):
        """NTT-domain digits [..., kdig, k, N] against two key components
        [kdig, k, N], fused into the inverse transform (B5 on the card):
        -> coefficient domain [..., 2, k, N]."""
        return self.plan.inv_ks(d_hat, k0, k1)

    def ks_full(self, d_rns, k0, k1):
        """The whole blind-rotation step in one kernel (B15 on the card):
        coefficient-domain digit residues [..., kdig, k, N] -> forward
        transforms, contraction against both key components, inverse ->
        [..., 2, k, N]."""
        return self.plan.ks_full_limbs(d_rns, k0, k1)

    def to_torus(self, x_rns):
        """[..., k, N] residues of a centered value -> exact torus words;
        valid for |X| < C/2 (1 - 2^-27). Each y_i g_i is below 2^61, so
        the k-term sum plus 2^59 stays below 2^63."""
        y = self.base.normalize_digits(x_rns)
        alpha = srl((y * self.g60).sum(-2) + (1 << 59), 60)
        total = (y * self.theta).sum(-2)          # wraps mod 2^64
        return total - alpha * self.c_mod

    def br_glue_plain(self, acc, upd, e, radix_log: int, count: int):
        """`br_glue` in plain PyTorch (its twin on the CPU and the kernel's
        oracle on the card)."""
        if upd is not None:
            acc = acc + self.to_torus(upd)          # wrapping add: CMUX
        if e is None:
            return acc, None
        rotated = negacyclic_monomial_mul(acc, e, self.n)
        return acc, self.signed_to_rns(
            torus.gadget_digits(rotated - acc, radix_log, count))

    def br_glue(self, acc, upd, e, radix_log: int, count: int):
        """The glue of a blind-rotation step around its kernels, for the
        GLWE accumulator acc [..., C, N]: with upd [..., C, k, N] (the
        step's product in residues, B5's output), acc + to_torus(upd);
        then, with e [...] (one exponent in [0, 2N) a ciphertext), the
        residues [..., C l, k, N] of the `count` gadget digits of
        X^e acc - acc (index c l + j), which the next step's B1 or B15
        reads. upd None skips the add (a rotation's first step), e None the
        digits (after its last). Returns (acc, digits or None). On a CUDA
        tensor one launch of `csrc/br_glue.cu`; on a CPU tensor the plain
        twin; never one for the other."""
        if upd is None and e is None:
            raise ValueError("br_glue needs upd, e or both")
        if acc.dim() < 2:
            raise ValueError(f"br_glue: acc [..., C, N], got "
                             f"{tuple(acc.shape)}")
        lead, comps = tuple(acc.shape[:-2]), acc.shape[-2]
        k, n = self.base.k, self.n
        for name, x, shape in (("acc", acc, lead + (comps, n)),
                               ("upd", upd, lead + (comps, k, n)),
                               ("e", e, lead)):
            if x is None:
                continue
            if x.dtype != torch.int64 or x.device != self.device:
                raise ValueError(f"br_glue: {name} must be int64 on "
                                 f"{self.device}, got {x.dtype} on "
                                 f"{x.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"br_glue: {name} has shape "
                                 f"{tuple(x.shape)}, expected {shape}")
        if e is not None and not (
                1 <= radix_log <= GLUE_MAX_RADIX_LOG and count >= 1
                and count * radix_log <= 64):
            raise ValueError(f"br_glue: no {count} digits of {radix_log} "
                             f"bits (1 <= radix_log <= "
                             f"{GLUE_MAX_RADIX_LOG}, count radix_log <= 64)")
        if acc.device.type == "cpu":
            return self.br_glue_plain(acc, upd, e, radix_log, count)
        if acc.device.type != "cuda":
            raise ValueError(f"br_glue: unsupported device {acc.device}")
        if not GLUE_MIN_N <= n <= GLUE_MAX_N:
            raise ValueError(f"br_glue kernel holds {GLUE_MIN_N} <= N <= "
                             f"{GLUE_MAX_N}, got {n}")
        if not all(x is None or x.is_contiguous() for x in (acc, upd, e)):
            raise ValueError("br_glue: operands must be contiguous")
        rows = 1
        for d in lead:
            rows *= d
        acc_out = None if upd is None else torch.empty_like(acc)
        digits = None if e is None else torch.empty(
            *lead, comps * count, k, n, dtype=torch.int64, device=acc.device)
        if rows and comps:
            _build.launch("br_glue", "br_glue", acc, upd, e, acc_out, digits,
                          self.glue_tab, rows, comps, k, count, radix_log,
                          n.bit_length() - 1)
            _build.LAUNCHES["br_glue"] += 1
        return (acc if acc_out is None else acc_out), digits


@lru_cache(maxsize=8)
def _torus_plan_u32(n: int, k: int, device: torch.device):
    return TorusNttPlanU32(n, k, device)


@lru_cache(maxsize=16)
def _torus_plan(n: int, k: int, device: torch.device):
    return TorusNttPlan(n, k, device)


def get_torus_plan_u32(n: int, k: int = 4, device=None) -> TorusNttPlanU32:
    """Cached u32 torus plan; `device` None means CUDA."""
    return _torus_plan_u32(n, k, resolve_device(device))


def get_torus_plan(n: int, k: int = 2, device=None) -> TorusNttPlan:
    """Cached 62-bit torus plan: k=2 (C ~ 2^124) covers small-digit x
    torus products, k=3 (C ~ 2^186) full torus x torus products, which
    keeps uniform (non-binary) secret keys exact. `device` None means
    CUDA."""
    return _torus_plan(n, k, resolve_device(device))


def negacyclic_monomial_mul(poly, e, n: int):
    """X^e * poly for exponents e in [0, 2N), gathered with sign. poly is
    [..., N] torus words; e is a python int or an int64 tensor whose
    shape matches poly's leading dims from the left (one exponent per
    ciphertext of a batch: e [batch] against GLWE rows [batch, k+1, N])."""
    e = torch.as_tensor(e, dtype=torch.int64, device=poly.device)
    src = (torch.arange(n, device=poly.device) - e.unsqueeze(-1)) % (2 * n)
    neg = src >= n
    src = torch.where(neg, src - n, src)
    extra = poly.dim() - 1 - e.dim()
    if extra > 0:
        shape = tuple(e.shape) + (1,) * extra + (n,)
        src, neg = src.reshape(shape), neg.reshape(shape)
    full = torch.broadcast_shapes(poly.shape, src.shape)
    gathered = torch.gather(poly.expand(full), -1, src.expand(full))
    return torch.where(neg, -gathered, gathered)

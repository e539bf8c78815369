"""NTT plan selection (port of `sunscreen_tpu/math/ntt.py`).

`get_plan` resolves a mode as the reference does (`resolve_mode`: the
argument, else `SUNSCREEN_TPU_NTT`, else the legacy
`SUNSCREEN_TPU_COMPACT_NTT=1` for "compact", else the device's default),
applies the reference's degrade rules in its order, and returns one of
the ported plans:

* "pallas": `pmntt.NttPlanU32`, kernels B1-B5, B12-B15;
* "pallas_vpu": `pntt.PallasNttPlan`, kernels B16 and B17;
* "unrolled" and "compact": `NttPlan`, the port of the reference's u64
  `NttPlan` (natural order in, bit-reversed order out) for moduli below
  2^62, in plain PyTorch on every device, as the reference's plan is
  plain XLA. The reference's "compact" runs the same butterflies as one
  constant-geometry loop and gives the same bits, so here it is the
  same stages under its own label; TFHE's 62-bit `TorusNttPlan` and the
  plain-ring plans of small t run on it (`get_plan_u64` builds it
  directly);
* "matmul": `mntt.MatmulNttPlan`, whose NTT domain is natural order.

The default mode (C2 in ROADMAP): "pallas" on CUDA, degraded as the
reference degrades it off the CPU; on the CPU "pallas" too while every
modulus fits the u32 engine, since the port's CPU path is the twin of
its card path, and the reference's CPU default "unrolled" for the u64
engine, so that u64 NTT-domain arrays match the reference's under
default settings on both sides.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import primes
from sunscreen_tpu_torch.math import pmntt
from sunscreen_tpu_torch.math.pmntt import NttPlanU32, _bitrev, _powers
from sunscreen_tpu_torch.math.pntt import PallasNttPlan
from sunscreen_tpu_torch.math.rns import _col


def resolve_mode(mode: str | None = None, device=None,
                 moduli: tuple[int, ...] = ()) -> str:
    """The NTT mode to use: `mode`, else SUNSCREEN_TPU_NTT, else
    "compact" under SUNSCREEN_TPU_COMPACT_NTT=1, else the default:
    "unrolled" on the CPU for moduli above the u32 engine's 30 bits,
    else "pallas" (`device` None means CUDA). The reference reads the
    legacy setting once at import; this reads both settings on every
    call."""
    if mode:
        return mode
    env = os.environ.get("SUNSCREEN_TPU_NTT", "")
    if env:
        return env
    if os.environ.get("SUNSCREEN_TPU_COMPACT_NTT", "") == "1":
        return "compact"
    if (device is not None and torch.device(device).type == "cpu"
            and moduli and m.word_dtype_for(moduli) == m.U64):
        return "unrolled"
    return "pallas"


def degrade(n: int, moduli: tuple[int, ...], mode: str) -> str:
    """The reference's fallbacks for moduli or N outside a mode's
    envelope (`ntt.py:324-334`), in its order."""
    hi = max(q.bit_length() for q in moduli)
    lo = min(q.bit_length() for q in moduli)
    if mode == "pallas" and (hi > 30 or n < 256):
        mode = "matmul"
    if mode == "pallas_vpu" and (hi > 30 or n < 128):
        mode = "matmul"
    if mode == "pallas_vpu" and lo < 17:
        mode = "unrolled"
    if mode == "pallas" and lo < 17:
        mode = "unrolled"
    if mode == "matmul" and hi > 57:
        mode = "compact"
    return mode


@lru_cache(maxsize=64)
def _plan_cached(n: int, moduli: tuple[int, ...], device: torch.device,
                 mode: str):
    if mode == "pallas" and n > pmntt.MAX_N:
        raise Unsupported(f'NTT mode "pallas" holds N <= {pmntt.MAX_N}, '
                          f"got {n}")
    if mode == "pallas":
        return NttPlanU32(n, moduli, device)
    if mode == "pallas_vpu":
        return PallasNttPlan(n, moduli, device)
    if mode in ("unrolled", "compact"):
        return NttPlan(n, moduli, device, mode)
    if mode == "matmul":
        from sunscreen_tpu_torch.math.mntt import MatmulNttPlan
        return MatmulNttPlan(n, moduli, device)
    raise ValueError(f"unknown NTT mode {mode!r}")


def get_plan(n: int, moduli: tuple[int, ...], device=None,
             mode: str | None = None):
    """Shared plan cache; `device` None means CUDA, `mode` None means
    `resolve_mode()`'s default for the device and moduli, degraded
    outside its envelope as the reference does."""
    moduli = tuple(int(q) for q in moduli)
    dev = resolve_device(device)
    return _plan_cached(n, moduli, dev,
                        degrade(n, moduli, resolve_mode(mode, dev, moduli)))


def same_domain(a: str, b: str) -> bool:
    """Whether plans of modes a and b share their NTT domain: "compact"
    gives "unrolled"'s bits."""
    def dom(x):
        return "unrolled" if x == "compact" else x
    return dom(a) == dom(b)


def _shoup_mul(x, w, w_sh, q):
    """(x w) mod q for u64 x < 2^62, w < q < 2^62 and
    w_sh = floor(w 2^64 / q): the wrapped difference lies in [0, 2q)."""
    r = w * x - m.mul_hi(x, w_sh) * q
    return torch.where(r >= q, r - q, r)


class NttPlan:
    """u64 negacyclic NTT tables for a stack of moduli below 2^62:
    decimation-in-time Cooley-Tukey with psi folded into the twiddles,
    natural order in and bit-reversed order out, the Gentleman-Sande
    mirror with 1/N for the inverse; Shoup twiddle multiplies. The same
    stages, hence the same NTT-domain arrays, as the reference's modes
    "unrolled" and "compact" (`mode`). Tensors are int64 [..., k, N]
    (values < q) on the plan's device."""

    def __init__(self, n: int, moduli: tuple[int, ...], device,
                 mode: str = "unrolled"):
        assert mode in ("unrolled", "compact"), mode
        assert n & (n - 1) == 0, "N must be a power of two"
        assert max(q.bit_length() for q in moduli) <= 62
        self.n = n
        self.log_n = n.bit_length() - 1
        self.moduli = tuple(int(q) for q in moduli)
        self.k = len(self.moduli)
        self.mode = mode
        rev = _bitrev(n)
        fw, iw, fw_sh, iw_sh = [], [], [], []
        for q in self.moduli:
            assert q % (2 * n) == 1, f"q={q} is not NTT-friendly for N={n}"
            psi = primes.min_root_of_unity(2 * n, q)
            f = [int(v) for v in _powers(psi, n, q)[rev]]
            i = [int(v) for v in _powers(pow(psi, -1, q), n, q)[rev]]
            fw.append(f)
            iw.append(i)
            fw_sh.append([m.s64((w << 64) // q) for w in f])
            iw_sh.append([m.s64((w << 64) // q) for w in i])

        def dev(a):
            return torch.as_tensor(np.array(a, dtype=np.int64),
                                   device=device)

        self.q = _col(self.moduli, device)                 # [k, 1]
        self.device = self.q.device
        self.psi_rev, self.psi_rev_sh = dev(fw), dev(fw_sh)  # [k, N]
        self.ipsi_rev, self.ipsi_rev_sh = dev(iw), dev(iw_sh)
        ninv = [pow(n, -1, q) for q in self.moduli]
        self.n_inv = _col(ninv, device)
        self.n_inv_sh = _col([(v << 64) // q for v, q in
                              zip(ninv, self.moduli)], device)
        ratios = [m.barrett_ratio(q) for q in self.moduli]
        self.r_hi = _col([r[0] for r in ratios], device)
        self.r_lo = _col([r[1] for r in ratios], device)

    def fwd(self, x):
        """[..., k, N] natural order -> bit-reversed NTT domain."""
        n, k = self.n, self.k
        batch = x.shape[:-2]
        q3 = self.q.view(k, 1, 1)
        for s in range(self.log_n):
            mm, t = 1 << s, n >> (s + 1)
            xv = x.reshape(*batch, k, mm, 2, t)
            u, v0 = xv[..., 0, :], xv[..., 1, :]
            v = _shoup_mul(v0, self.psi_rev[:, mm:2 * mm].view(k, mm, 1),
                           self.psi_rev_sh[:, mm:2 * mm].view(k, mm, 1), q3)
            x = torch.stack((m.add_mod(u, v, q3), m.sub_mod(u, v, q3)),
                            -2).reshape(*batch, k, n)
        return x

    def inv(self, x):
        """Bit-reversed NTT domain -> [..., k, N] natural order."""
        n, k = self.n, self.k
        batch = x.shape[:-2]
        q3 = self.q.view(k, 1, 1)
        for s in reversed(range(self.log_n)):
            mm, t = 1 << s, n >> (s + 1)
            xv = x.reshape(*batch, k, mm, 2, t)
            y0, y1 = xv[..., 0, :], xv[..., 1, :]
            v = _shoup_mul(m.sub_mod(y0, y1, q3),
                           self.ipsi_rev[:, mm:2 * mm].view(k, mm, 1),
                           self.ipsi_rev_sh[:, mm:2 * mm].view(k, mm, 1), q3)
            x = torch.stack((m.add_mod(y0, y1, q3), v),
                            -2).reshape(*batch, k, n)
        return _shoup_mul(x, self.n_inv, self.n_inv_sh, self.q)

    # the reference's loop form of "compact" gives the same bits
    fwd_compact = fwd
    inv_compact = inv

    def pointwise_mul(self, a, b):
        """Exact (a * b) mod q per limb on NTT-domain arrays [..., k, N]."""
        return m.mul_mod(a, b, self.q, self.r_hi, self.r_lo)

    def negacyclic_mul(self, a, b):
        """Negacyclic poly product of coefficient-domain stacks."""
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))


@lru_cache(maxsize=16)
def _plan_u64_cached(n: int, moduli: tuple[int, ...], device: torch.device):
    return NttPlan(n, moduli, device)


def get_plan_u64(n: int, moduli: tuple[int, ...], device=None) -> NttPlan:
    """Shared cache of u64 plans; `device` None means CUDA."""
    return _plan_u64_cached(n, tuple(int(q) for q in moduli),
                            resolve_device(device))

"""Negacyclic NTT over u32 RNS limb stacks: the port of
`sunscreen_tpu/math/pmntt.py::PallasMatmulNttPlan`.

The NTT domain is the reference's, so keys and NTT-domain arrays move
between the packages unchanged: for N = n1 * 128, flat position
j2 * n1 + j1 of a limb holds sum_i x_i (psi omega^J)^i with
J = j2 + 128 j1, psi the minimal primitive 2N-th root of unity mod q and
omega = psi^2. `inv` maps that domain back to natural coefficient order
with 1/N folded in.

Each transform entry point has two implementations with identical
results. On a CUDA tensor it launches a hand-written kernel
(`csrc/ntt.cu`, `csrc/tensor3.cu`, `csrc/inv_ks.cu`, `csrc/inv_tensor3.cu`,
`csrc/ks_full.cu`) and counts the launch in `_build.LAUNCHES`; on a CPU
tensor it runs the plain PyTorch twin (`*_plain`), a vectorized radix-2
transform in int64 that also serves as the kernels' oracle on the card.
There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import primes
from sunscreen_tpu_torch.math.prns import _check, _strided_rows

LANES = 128            # n2 of the reference's four-step layout
MAX_KDIG = 16          # kdig * q^2 < 2^64 for q < 2^30 (inv_ks.cu)
MAX_N = 16384          # the reference asserts N <= 16384 (pmntt.py:782)
TENSOR3_MAX_N = 16384  # B4, B12, B13: three polys, 192 KB of a block's 227 KB


def _bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _powers(base: int, n: int, q: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * base % q
    return out


def kernel_tables(n: int, moduli: tuple[int, ...]):
    """The radix-2 tables of the u32 transforms for N = 2^logn and
    17-30-bit moduli q = 1 mod 2N: psi_rev and ipsi_rev [k, N] int64
    (psi^brev(i), psi the minimal primitive 2N-th root of unity mod q),
    tw [k, 4, N] int32 (the u32 bits of psi_rev, its Shoup ratios,
    ipsi_rev and its Shoup ratios; `twiddle_pairs` packs it for the
    kernels) and consts [k, 4] int64 (q, floor(2^64 / q), N^-1 mod q and
    its Shoup ratio, `csrc/common.cuh`)."""
    rev = _bitrev(n)
    psi_rev, ipsi_rev, consts = [], [], []
    for q in moduli:
        assert q % (2 * n) == 1, f"q={q} not NTT-friendly for N={n}"
        psi = primes.min_root_of_unity(2 * n, q)
        psi_rev.append(_powers(psi, n, q)[rev])
        ipsi_rev.append(_powers(pow(psi, -1, q), n, q)[rev])
        ninv = pow(n, -1, q)
        consts.append((q, (1 << 64) // q, ninv, m.shoup_ratio32(ninv, q)))
    psi_rev, ipsi_rev = np.stack(psi_rev), np.stack(ipsi_rev)
    qs = np.array(moduli, dtype=np.int64)[:, None]
    tw = np.stack([psi_rev, (psi_rev << 32) // qs,
                   ipsi_rev, (ipsi_rev << 32) // qs], axis=1)
    return (psi_rev, ipsi_rev, tw.astype(np.uint32).view(np.int32),
            np.array(consts, dtype=np.int64))


def twiddle_pairs(tw: np.ndarray) -> np.ndarray:
    """The transform kernels' twiddle table (`csrc/transform.cuh`) from
    `kernel_tables`' tw [k, 4, N]: [k, 2, N] int64, row 0 psi_rev and
    row 1 ipsi_rev, each entry w | floor(w 2^32 / q) << 32 (the u64 bits),
    so that one 8-byte load gives a twiddle and its Shoup ratio."""
    u = tw.view(np.uint32).astype(np.uint64)
    pairs = np.stack([u[:, 0] | u[:, 1] << np.uint64(32),
                      u[:, 2] | u[:, 3] << np.uint64(32)], axis=1)
    return pairs.view(np.int64)


class NttPlanU32:
    """u32-engine negacyclic NTT plan for 17-30-bit NTT-friendly moduli
    and 256 <= N <= 16384, with the reference plan's call surface.
    Tensors are int64 [..., k, N] on the plan's device."""

    def __init__(self, n: int, moduli: tuple[int, ...], device):
        assert n & (n - 1) == 0 and 256 <= n <= MAX_N, n
        assert max(q.bit_length() for q in moduli) <= 30
        assert min(q.bit_length() for q in moduli) >= 17
        self.n = n
        self.logn = n.bit_length() - 1
        self.moduli = tuple(int(q) for q in moduli)
        self.k = len(self.moduli)
        self.mode = "pallas"
        n1 = n // LANES
        rev = _bitrev(n)
        # flat position p -> natural index J -> bit-reversed slot
        p = np.arange(n)
        nat = p // n1 + LANES * (p % n1)
        fwd_gather = rev[nat]                      # out[p] = a[rev[J(p)]]
        inv_gather = np.empty(n, dtype=np.int64)
        inv_gather[fwd_gather] = p                 # a[rev[J(p)]] = y[p]
        psi_rev, ipsi_rev, tw, consts = kernel_tables(n, self.moduli)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        # plain-twin tables
        self.q = dev(np.array(self.moduli, dtype=np.int64)[:, None])  # [k, 1]
        self.device = self.q.device                # "cuda" -> "cuda:0"
        self.psi_rev = dev(psi_rev)                # [k, N]
        self.ipsi_rev = dev(ipsi_rev)
        self.ninv = dev(consts[:, 2:3])
        self.fwd_gather = dev(fwd_gather)
        self.inv_gather = dev(inv_gather)
        # kernel tables: [k, 2, N] twiddle pairs and [k, 4] int64
        self.twp = torch.as_tensor(twiddle_pairs(tw), device=self.device)
        self.consts = dev(consts)

    # -- plain PyTorch twins (any device) -----------------------------------

    def fwd_plain(self, x):
        """[..., k, N] coefficients (any value in [0, 2^63)) -> flat NTT
        domain: Cooley-Tukey with merged psi twiddles, natural order in,
        bit-reversed out, then the flat-domain gather."""
        lead, k, n = x.shape[:-2], self.k, self.n
        q3 = self.q.view(k, 1, 1)
        a = x % self.q
        t, groups = n, 1
        while groups < n:
            t //= 2
            a = a.reshape(*lead, k, groups, 2, t)
            s = self.psi_rev[:, groups:2 * groups].view(k, groups, 1)
            u, v = a[..., 0, :], a[..., 1, :] * s % q3
            a = torch.stack([m.add_mod(u, v, q3), m.sub_mod(u, v, q3)], -2)
            groups *= 2
        return a.reshape(*lead, k, n)[..., self.fwd_gather]

    def inv_plain(self, x):
        """Flat NTT domain -> [..., k, N] natural coefficients:
        Gentleman-Sande with psi^-1 twiddles, then 1/N."""
        lead, k, n = x.shape[:-2], self.k, self.n
        q3 = self.q.view(k, 1, 1)
        a = (x % self.q)[..., self.inv_gather]
        t, groups = 1, n // 2
        while groups >= 1:
            a = a.reshape(*lead, k, groups, 2, t)
            s = self.ipsi_rev[:, groups:2 * groups].view(k, groups, 1)
            u, v = a[..., 0, :], a[..., 1, :]
            a = torch.stack([m.add_mod(u, v, q3),
                             m.sub_mod(u, v, q3) * s % q3], -2)
            t *= 2
            groups //= 2
        return a.reshape(*lead, k, n) * self.ninv % self.q

    def fwd_broadcast_plain(self, x):
        """[..., N] raw u32 polys -> [..., k, N]: each transformed under
        every limb modulus."""
        return self.fwd_plain(
            x.unsqueeze(-2).expand(*x.shape[:-1], self.k, self.n))

    def fwd_tensor3_plain(self, ext):
        """[..., 4, k, N] (a0, a1, b0, b1) -> [..., 3, k, N] NTT-domain
        (a0 b0, a0 b1 + a1 b0, a1 b1) mod q."""
        both = self.fwd_plain(ext)
        return m.tensor3_mod(both[..., :2, :, :], both[..., 2:, :, :], self.q)

    def fwd_tensor3_full_plain(self, ext):
        """[..., 4, k, N] (a0, a1, b0, b1) -> [..., 3, k, N]
        coefficient-domain tensor: B13's twin, `fwd_tensor3_plain` then
        `inv_plain`."""
        return self.inv_plain(self.fwd_tensor3_plain(ext))

    def inv_tensor3_plain(self, a_hat, b_hat):
        """a_hat, b_hat [..., 2, k, N] (flat NTT domain, values < q) ->
        [..., 3, k, N] coefficient-domain tensor: B10's twin, then
        `inv_plain`."""
        return self.inv_plain(m.tensor3_mod(a_hat, b_hat, self.q))

    def inv_ks_plain(self, d_hat, k0, k1):
        """d_hat [..., kdig, k, N], keys [kdig, k, N] (flat NTT domain,
        values < q) -> [..., 2, k, N] = INTT(sum_i d_i key_i mod q)."""
        return self.inv_plain(m.ks_inner_mod(d_hat, k0, k1, self.q))

    def ks_full_plain(self, d, k0, k1):
        """d [..., kdig, N] raw u32 digits, keys [kdig, k, N] (flat NTT
        domain) -> [..., 2, k, N] = INTT(sum_i NTT(d_i) key_i mod q) per
        limb: B14's twin, `fwd_broadcast_plain` then `inv_ks_plain`."""
        return self.inv_ks_plain(self.fwd_broadcast_plain(d), k0, k1)

    def ks_full_limbs_plain(self, d, k0, k1):
        """d [..., kdig, k, N] coefficient-domain residues, keys
        [kdig, k, N] -> [..., 2, k, N]: B15's twin, `fwd_plain` then
        `inv_ks_plain`."""
        return self.inv_ks_plain(self.fwd_plain(d), k0, k1)

    # -- kernel entry points -------------------------------------------------

    def _prep(self, x, tail: tuple[int, ...]):
        """Validated contiguous input and its row count for a kernel."""
        if x.device != self.device or x.dtype != torch.int64:
            raise ValueError(
                f"expected int64 on {self.device}, got {x.dtype} on "
                f"{x.device}")
        if tuple(x.shape[-len(tail):]) != tail:
            raise ValueError(f"expected trailing shape {tail}, got "
                             f"{tuple(x.shape)}")
        x = x.contiguous()
        rows = 1
        for d in x.shape[:-len(tail)]:
            rows *= d
        return x, rows

    @staticmethod
    def _cpu(x) -> bool:
        if x.device.type == "cpu":
            return True
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return False

    def fwd(self, x):
        """[..., k, N] coefficients -> NTT domain (flat (j2, j1))."""
        if self._cpu(x):
            return self.fwd_plain(x)
        x, rows = self._prep(x, (self.k, self.n))
        out = torch.empty_like(x)
        if rows:
            _build.launch("ntt", "ntt_fwd", x, out, self.twp, self.consts,
                          rows, self.k, self.logn, 0)
            _build.LAUNCHES["fwd"] += 1
        return out

    def fwd_broadcast(self, x):
        """[..., N] (one poly per row, any u32 values) -> [..., k, N]:
        the same coefficients transformed under every limb modulus; the
        k-fold broadcast is never materialized."""
        if self._cpu(x):
            return self.fwd_broadcast_plain(x)
        x, rows = self._prep(x, (self.n,))
        out = torch.empty(*x.shape[:-1], self.k, self.n, dtype=torch.int64,
                          device=x.device)
        if rows:
            _build.launch("ntt", "ntt_fwd", x, out, self.twp, self.consts,
                          rows, self.k, self.logn, 1)
            _build.LAUNCHES["fwd_broadcast"] += 1
        return out

    def inv(self, x):
        """NTT domain -> [..., k, N] natural coefficient order."""
        if self._cpu(x):
            return self.inv_plain(x)
        x, rows = self._prep(x, (self.k, self.n))
        out = torch.empty_like(x)
        if rows:
            _build.launch("ntt", "ntt_inv", x, out, self.twp, self.consts,
                          rows, self.k, self.logn)
            _build.LAUNCHES["inv"] += 1
        return out

    def fwd_tensor3(self, ext, full: bool = False):
        """ext [..., 4, k, N] coefficient-domain (a0, a1, b0, b1) ->
        [..., 3, k, N] BFV tensor: NTT domain (B4), or with full=True the
        coefficient domain, the three inverse transforms run in the same
        kernel (B13). The operands' NTT image never exists in device
        memory, nor, with full=True, the tensor's."""
        if self._cpu(ext):
            return (self.fwd_tensor3_full_plain(ext) if full
                    else self.fwd_tensor3_plain(ext))
        if self.n > TENSOR3_MAX_N:
            raise ValueError(f"fwd_tensor3 kernel holds N <= "
                             f"{TENSOR3_MAX_N}, got {self.n}")
        ext, rows = self._prep(ext, (4, self.k, self.n))
        out = torch.empty(*ext.shape[:-3], 3, self.k, self.n,
                          dtype=torch.int64, device=ext.device)
        if rows:
            _build.launch("tensor3", "fwd_tensor3", ext, out, self.twp,
                          self.consts, rows, self.k, self.logn, int(full))
            _build.LAUNCHES["fwd_tensor3_full" if full
                            else "fwd_tensor3"] += 1
        return out

    def inv_ks(self, d_hat, k0, k1):
        """d_hat [..., kdig, k, N], keys k0/k1 [kdig, k, N] (flat NTT
        domain, values < q) -> [..., 2, k, N] coefficient domain: the
        keyswitch digit contraction fused into the inverse transform of
        both key components."""
        if self._cpu(d_hat):
            return self.inv_ks_plain(d_hat, k0, k1)
        kdig = d_hat.shape[-3]
        if kdig > MAX_KDIG:
            raise ValueError(f"inv_ks: kdig={kdig} > {MAX_KDIG} would "
                             f"overflow the u64 accumulators")
        d_hat, rows = self._prep(d_hat, (kdig, self.k, self.n))
        k0, _ = self._prep(k0, (kdig, self.k, self.n))
        k1, _ = self._prep(k1, (kdig, self.k, self.n))
        if k0.dim() != 3 or k1.dim() != 3:
            raise ValueError("keys must be [kdig, k, N]")
        out = torch.empty(*d_hat.shape[:-3], 2, self.k, self.n,
                          dtype=torch.int64, device=d_hat.device)
        if rows:
            _build.launch("inv_ks", "inv_ks", d_hat, k0, k1, out, self.twp,
                          self.consts, rows, kdig, self.k, self.logn)
            _build.LAUNCHES["inv_ks"] += 1
        return out

    def _ks_full_launch(self, d, k0, k1, tail, per_limb: int, name: str):
        kdig = d.shape[-len(tail)]
        d, rows = self._prep(d, tail)
        keys = []
        for key in (k0, k1):
            key, _ = self._prep(key, (kdig, self.k, self.n))
            if key.dim() != 3:
                raise ValueError("keys must be [kdig, k, N]")
            keys.append(key)
        out = torch.empty(*d.shape[:-len(tail)], 2, self.k, self.n,
                          dtype=torch.int64, device=d.device)
        if rows:
            _build.launch("ks_full", "ks_full", d, *keys, out, self.twp,
                          self.consts, rows, kdig, self.k, self.logn,
                          per_limb)
            _build.LAUNCHES[name] += 1
        return out

    def ks_full(self, d, k0, k1):
        """d [..., kdig, N] raw coefficient-domain u32 digits (any value),
        keys k0/k1 [kdig, k, N] (flat NTT domain) -> [..., 2, k, N]
        coefficient domain: each digit transformed under every limb, the
        contraction with both key components and the two inverse
        transforms in one kernel (the reference's `ks_full`, B14). Neither
        the broadcast digits nor their NTT image reach device memory."""
        if self._cpu(d):
            return self.ks_full_plain(d, k0, k1)
        return self._ks_full_launch(d, k0, k1, (d.shape[-2], self.n), 0,
                                    "ks_full")

    def ks_full_limbs(self, d, k0, k1):
        """d [..., kdig, k, N] coefficient-domain residues, one per limb
        (TFHE's signed digits), keys [kdig, k, N] -> [..., 2, k, N]: B14
        reading each limb's own digit residues (the reference's
        `ks_full_limbs`, B15)."""
        if self._cpu(d):
            return self.ks_full_limbs_plain(d, k0, k1)
        return self._ks_full_launch(d, k0, k1,
                                    (d.shape[-3], self.k, self.n), 1,
                                    "ks_full_limbs")

    def inv_tensor3(self, a_hat, b_hat):
        """a_hat, b_hat [..., 2, k, N] (flat NTT domain, values < q) ->
        [..., 3, k, N] coefficient-domain BFV tensor (a0 b0, a0 b1 + a1 b0,
        a1 b1): the component products fused into the inverse transform
        of all three, so the NTT-domain tensor never exists in device
        memory. The operands may be views of one stack (the halves of a
        forward-transformed [..., 4, k, N]): evenly strided rows are read
        in place."""
        if self._cpu(a_hat):
            return self.inv_tensor3_plain(a_hat, b_hat)
        if self.n > TENSOR3_MAX_N:
            raise ValueError(f"inv_tensor3 kernel holds N <= "
                             f"{TENSOR3_MAX_N}, got {self.n}")
        tail = (2, self.k, self.n)
        rows = _check(a_hat, self.device, tail)
        if a_hat.shape != b_hat.shape:
            raise ValueError(f"operands differ in shape: "
                             f"{tuple(a_hat.shape)} vs {tuple(b_hat.shape)}")
        _check(b_hat, self.device, tail)
        a, sa = _strided_rows(a_hat, 3)
        b, sb = _strided_rows(b_hat, 3)
        out = torch.empty(*a_hat.shape[:-3], 3, self.k, self.n,
                          dtype=torch.int64, device=a_hat.device)
        if rows:
            _build.launch("inv_tensor3", "inv_tensor3", a, b, out, self.twp,
                          self.consts, rows, self.k, self.logn, sa, sb)
            _build.LAUNCHES["inv_tensor3"] += 1
        return out

    # -- pointwise (plain PyTorch on every device) ---------------------------

    def pointwise_mul(self, a, b):
        """Exact (a * b) mod q per limb on NTT-domain stacks [..., k, N]."""
        return a * b % self.q

    def negacyclic_mul(self, a, b):
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))

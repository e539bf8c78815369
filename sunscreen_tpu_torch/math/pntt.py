"""The u32 NTT plan of mode "pallas_vpu": the port of
`sunscreen_tpu/math/pntt.py::PallasNttPlan`.

Its NTT domain is the reference plan's own, so keys and NTT-domain arrays
move between the packages unchanged. The reference views a poly as
X[R, C] (C = 128 lanes, or N/2 below N = 256; i = r C + c) and runs a
negacyclic row NTT, a mid twiddle, a transpose and a cyclic column NTT;
position t' R + s' of a limb then holds the evaluation at psi^(2J + 1),
J = brev(s') + R brev(t') (bit reversal over log2 R and log2 C bits),
psi the minimal primitive 2N-th root of unity mod q. `inv` maps that
domain back to natural coefficient order with 1/N folded in.

The plain twins (`fwd_plain`, `inv_plain`, `pointwise_mul_plain`) repeat
the reference's stages on int64; they are the CPU path and the kernels'
oracle. On a CUDA tensor `fwd` and `inv` launch B16 and `pointwise_mul`
launches B17 (`csrc/pntt.cu`), counted in `_build.LAUNCHES` as
"pntt_fwd", "pntt_inv" and "pntt_pmul". Above ONE_PASS_MAX_N a transform
is B16's two passes, each a kernel of its own through a u32 scratch
tensor: `fwd_rows` then `fwd_cols`, `inv_cols` then `inv_rows`, counted
under those names with a "pntt_" prefix; each pass has its plain twin, the
half of the reference's stages it computes. There is no fallback from a
kernel to its twin.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import primes
from sunscreen_tpu_torch.math.pmntt import (LANES, _bitrev, kernel_tables,
                                            twiddle_pairs)
from sunscreen_tpu_torch.math.prns import _check, _is_cpu

MIN_N = 128
ONE_PASS_MAX_N = 32768      # B16 in one pass: a poly in a block's shared memory
KERNEL_MAX_N = 1 << 21      # two passes: a column of R = N / 128 rows in a block
LEAD_DIMS = 4               # leading dims B17 reads through strides


def _merge_lead(sizes, sa, sb):
    """Leading dims (size, stride of a, stride of b) with size-1 dims
    dropped and neighbours merged where both operands allow it."""
    out: list[list[int]] = []
    for size, a, b in zip(sizes, sa, sb):
        if size == 1:
            continue
        if out and out[-1][1] == size * a and out[-1][2] == size * b:
            out[-1] = [out[-1][0] * size, a, b]
        else:
            out.append([size, a, b])
    return out


class PallasNttPlan:
    """Negacyclic NTT plan for 17-30-bit NTT-friendly moduli and
    N >= 128 (on CUDA N <= KERNEL_MAX_N, B16's largest size) in the
    reference's [t', s'] domain, with its call surface: `fwd`, `inv`,
    `pointwise_mul` (broadcasting) and `negacyclic_mul` over int64
    [..., k, N] stacks on the plan's device.
    `mode` is "pallas_vpu"; the reference's plan calls itself "pallas"
    (`pntt.py:222`), which `bfv/ops.py` accounts for."""

    def __init__(self, n: int, moduli: tuple[int, ...], device):
        assert n & (n - 1) == 0 and n >= MIN_N, n
        if torch.device(device).type == "cuda" and n > KERNEL_MAX_N:
            raise Unsupported(f"the B16 kernels hold N <= {KERNEL_MAX_N}, "
                              f"got {n}")
        assert max(q.bit_length() for q in moduli) <= 30
        assert min(q.bit_length() for q in moduli) >= 17
        self.n = n
        self.logn = n.bit_length() - 1
        self.moduli = tuple(int(q) for q in moduli)
        self.k = len(self.moduli)
        self.mode = "pallas_vpu"
        c = min(LANES, n // 2)
        r = n // c
        self.R, self.C = r, c
        self.log_r, self.log_c = r.bit_length() - 1, c.bit_length() - 1

        # the reference's stage tables, one entry per distinct twiddle:
        # row DIT psi_r^brev(i) (psi_r = psi^C), mid psi^(c (2 brev(s') + 1))
        # with 1/N folded into its inverse, column DIF w_c^j (w_c = psi^2R)
        row, irow, mid, imid, col, icol = ([] for _ in range(6))
        rev_r, rev_c = _bitrev(r), _bitrev(c)
        for q in self.moduli:
            assert q % (2 * n) == 1, f"q={q} not NTT-friendly for N={n}"
            psi = primes.min_root_of_unity(2 * n, q)
            psi_r, w_c = pow(psi, c, q), pow(psi, 2 * r, q)
            pr = [pow(psi_r, int(e), q) for e in rev_r]
            row.append(pr)
            irow.append([pow(w, -1, q) for w in pr])
            base = np.array([pow(psi, 2 * int(f) + 1, q) for f in rev_r])
            ibase = np.array([pow(int(b), -1, q) for b in base])
            fw = np.empty((r, c), dtype=np.int64)
            iw = np.empty((r, c), dtype=np.int64)
            fw[:, 0], iw[:, 0] = 1, pow(n, -1, q)
            for j in range(1, c):
                fw[:, j] = fw[:, j - 1] * base % q
                iw[:, j] = iw[:, j - 1] * ibase % q
            mid.append(fw)
            imid.append(iw)
            cw = [pow(w_c, j, q) for j in range(c // 2)]
            col.append(cw)
            icol.append([pow(w, -1, q) for w in cw])

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)

        self.q = dev(np.array(self.moduli)[:, None])          # [k, 1]
        self.device = self.q.device
        self.row_tw, self.irow_tw = dev(row), dev(irow)       # [k, R]
        self.mid, self.imid = dev(mid), dev(imid)             # [k, R, C]
        self.col_tw, self.icol_tw = dev(col), dev(icol)       # [k, C/2]

        # kernel tables: the twiddle pairs of every u32 transform kernel
        # (B16 leaves position p = t' R + s' at butterfly slot
        # brev(J(p)) = s' C + t', a bit rotation of p: no table)
        _, _, tw, consts = kernel_tables(n, self.moduli)
        self.twp = dev(twiddle_pairs(tw))
        self.consts = dev(consts)
        self.ninv = self.consts[:, 2:3]                       # [k, 1]
        p = np.arange(n)
        self.slot_j = rev_r[p % r] + r * rev_c[p // r]        # J(p)

    # -- plain PyTorch twins (any device) -----------------------------------

    def _rows_fwd(self, x):
        """x mod q, then the negacyclic row DIT over r (psi_R = psi^C):
        int64 [..., k, R, C], rows in bit-reversed order."""
        lead, k, r, c = x.shape[:-2], self.k, self.R, self.C
        q4 = self.q.view(k, 1, 1, 1)
        a = (x % self.q).reshape(*lead, k, r, c)
        for s in range(self.log_r):
            mm, t = 1 << s, r >> (s + 1)
            av = a.reshape(*lead, k, mm, 2, t, c)
            u = av[..., 0, :, :]
            v = av[..., 1, :, :] * self.row_tw[:, mm:2 * mm].view(
                k, mm, 1, 1) % q4
            a = torch.stack((m.add_mod(u, v, q4), m.sub_mod(u, v, q4)),
                            -3).reshape(*lead, k, r, c)
        return a

    def _cols_fwd(self, a):
        """[..., k, R, C] after the rows -> the [t', s'] domain: the mid
        twiddle, the transpose and the cyclic column DIF."""
        lead, k, r, c = a.shape[:-3], self.k, self.R, self.C
        q3, q4 = self.q.view(k, 1, 1), self.q.view(k, 1, 1, 1)
        a = (a * self.mid % q3).transpose(-1, -2)   # [..., k, C, R]
        for s in range(self.log_c):
            nb, h = 1 << s, c >> (s + 1)
            av = a.reshape(*lead, k, nb, 2, h, r)
            u, v = av[..., 0, :, :], av[..., 1, :, :]
            w = self.col_tw[:, ::nb][:, :h].view(k, 1, h, 1)
            a = torch.stack((m.add_mod(u, v, q4),
                             m.sub_mod(u, v, q4) * w % q4),
                            -3).reshape(*lead, k, c, r)
        return a.reshape(*lead, k, self.n)

    def _cols_inv(self, x):
        """[t', s'] domain -> [..., k, R, C]: the cyclic column inverse
        and the transpose, before the inverse mid twiddle."""
        lead, k, r, c = x.shape[:-2], self.k, self.R, self.C
        q4 = self.q.view(k, 1, 1, 1)
        a = (x % self.q).reshape(*lead, k, c, r)
        for s in reversed(range(self.log_c)):
            nb, h = 1 << s, c >> (s + 1)
            av = a.reshape(*lead, k, nb, 2, h, r)
            u = av[..., 0, :, :]
            v = av[..., 1, :, :] * self.icol_tw[:, ::nb][:, :h].view(
                k, 1, h, 1) % q4
            a = torch.stack((m.add_mod(u, v, q4), m.sub_mod(u, v, q4)),
                            -3).reshape(*lead, k, c, r)
        return a.transpose(-1, -2)

    def _rows_inv(self, a):
        """[..., k, R, C] -> natural coefficients [..., k, N]: the inverse
        row transforms."""
        lead, k, r, c = a.shape[:-3], self.k, self.R, self.C
        q4 = self.q.view(k, 1, 1, 1)
        for s in reversed(range(self.log_r)):
            mm, t = 1 << s, r >> (s + 1)
            av = a.reshape(*lead, k, mm, 2, t, c)
            y0, y1 = av[..., 0, :, :], av[..., 1, :, :]
            d = m.sub_mod(y0, y1, q4) * self.irow_tw[:, mm:2 * mm].view(
                k, mm, 1, 1) % q4
            a = torch.stack((m.add_mod(y0, y1, q4), d),
                            -3).reshape(*lead, k, r, c)
        return a.reshape(*lead, k, self.n)

    def fwd_plain(self, x):
        """[..., k, N] coefficients (any value in [0, 2^63)) -> [t', s']
        domain: the reference's `_fwd_body` stage for stage."""
        return self._cols_fwd(self._rows_fwd(x))

    def inv_plain(self, x):
        """[t', s'] domain -> [..., k, N] natural coefficients: the
        reference's `_inv_body` (1/N in the inverse mid twiddle)."""
        return self._rows_inv(self._cols_inv(x)
                              * self.imid % self.q.view(self.k, 1, 1))

    def fwd_rows_plain(self, x):
        """B16's first forward pass: the rows of `fwd_plain`, as int32
        [..., k, N] in [R, C] order."""
        return self._rows_fwd(x).reshape(x.shape).to(torch.int32)

    def fwd_cols_plain(self, a):
        """B16's second forward pass: int32 [..., k, N] from
        `fwd_rows_plain` -> the [t', s'] domain."""
        return self._cols_fwd(a.long().reshape(
            *a.shape[:-1], self.R, self.C))

    def inv_cols_plain(self, x):
        """B16's first inverse pass: the columns of `inv_plain` and its
        inverse mid twiddle without the 1/N, as int32 [..., k, N] in
        [R, C] order."""
        q3 = self.q.view(self.k, 1, 1)
        a = self._cols_inv(x) * self.imid % q3 * self.n % q3
        return a.reshape(x.shape).to(torch.int32)

    def inv_rows_plain(self, a):
        """B16's second inverse pass: int32 [..., k, N] from
        `inv_cols_plain` -> natural coefficients, 1/N folded in."""
        out = self._rows_inv(a.long().reshape(*a.shape[:-1], self.R, self.C))
        return out * self.ninv % self.q

    def pointwise_mul_plain(self, a, b):
        return a * b % self.q

    # -- kernel entry points -------------------------------------------------

    def _transform(self, x, fn: str, out_dtype=torch.int64,
                   in_dtype=torch.int64):
        rows = _check(x, self.device, (self.k, self.n), in_dtype)
        x = x.contiguous()
        out = torch.empty(x.shape, dtype=out_dtype, device=self.device)
        if rows:
            _build.launch("pntt", fn, x, out, self.twp, self.consts, rows,
                          self.k, self.logn)
            _build.LAUNCHES[fn] += 1
        return out

    def fwd(self, x):
        """[..., k, N] coefficients -> [t', s'] NTT domain (B16)."""
        if _is_cpu(x):
            return self.fwd_plain(x)
        if self.n <= ONE_PASS_MAX_N:
            return self._transform(x, "pntt_fwd")
        return self.fwd_cols(self.fwd_rows(x))

    def inv(self, x):
        """[t', s'] NTT domain -> [..., k, N] coefficients (B16)."""
        if _is_cpu(x):
            return self.inv_plain(x)
        if self.n <= ONE_PASS_MAX_N:
            return self._transform(x, "pntt_inv")
        return self.inv_rows(self.inv_cols(x))

    # B16's passes above ONE_PASS_MAX_N (on CUDA, N <= ONE_PASS_MAX_N
    # raises): the intermediate is a new int32 tensor.
    def fwd_rows(self, x):
        """int64 [..., k, N] coefficients -> `fwd_rows_plain`'s int32."""
        return self.fwd_rows_plain(x) if _is_cpu(x) else \
            self._transform(x, "pntt_fwd_rows", out_dtype=torch.int32)

    def fwd_cols(self, a):
        """int32 `fwd_rows` output -> the [t', s'] domain, int64."""
        return self.fwd_cols_plain(a) if _is_cpu(a) else \
            self._transform(a, "pntt_fwd_cols", in_dtype=torch.int32)

    def inv_cols(self, x):
        """int64 [t', s'] domain -> `inv_cols_plain`'s int32."""
        return self.inv_cols_plain(x) if _is_cpu(x) else \
            self._transform(x, "pntt_inv_cols", out_dtype=torch.int32)

    def inv_rows(self, a):
        """int32 `inv_cols` output -> coefficients, int64."""
        return self.inv_rows_plain(a) if _is_cpu(a) else \
            self._transform(a, "pntt_inv_rows", in_dtype=torch.int32)

    def pointwise_mul(self, a, b):
        """Exact (a * b) mod q per limb on NTT-domain stacks [..., k, N]
        whose leading dims broadcast (B17). A broadcast operand is read in
        place through its strides."""
        if _is_cpu(a):
            return self.pointwise_mul_plain(a, b)
        shape = torch.broadcast_shapes(a.shape, b.shape)
        tail = (self.k, self.n)
        for v in (a, b):
            _check(v, self.device, tail)
        a, b = (v if v.stride()[-2:] == (self.n, 1) else v.contiguous()
                for v in (a, b))
        a, b = a.expand(shape), b.expand(shape)
        lead = _merge_lead(shape[:-2], a.stride()[:-2], b.stride()[:-2])
        if len(lead) > LEAD_DIMS:
            a, b = a.contiguous(), b.contiguous()
            lead = _merge_lead(shape[:-2], a.stride()[:-2], b.stride()[:-2])
        lead = [[1, 0, 0]] * (LEAD_DIMS - len(lead)) + lead
        if max(self.k * self.n, *(abs(v) for d in lead for v in d)) \
                >= 1 << 31:
            raise ValueError(f"pointwise_mul: shape {tuple(shape)} needs "
                             f"offsets past 32 bits")
        out = torch.empty(shape, dtype=torch.int64, device=self.device)
        rows = out.numel() // (self.k * self.n)
        if rows:
            _build.launch("pntt", "pntt_pmul", a, b, out, self.consts,
                          self.k, self.logn, rows, *(d[0] for d in lead),
                          *(d[1] for d in lead), *(d[2] for d in lead))
            _build.LAUNCHES["pntt_pmul"] += 1
        return out

    def negacyclic_mul(self, a, b):
        """Negacyclic poly product of coefficient-domain stacks."""
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))

"""Plain BFV decryption and plaintext arithmetic, the check's reference for
the BFV cells.

Plain PyTorch on int64 tensors, written from the scheme's definition and
sharing nothing with the program under test: a ciphertext (c0, c1) over
Q = q_1 ... q_k, in the coefficient domain as int64 residues
[..., 2, k, N], decrypts to m = round(t (c0 + c1 s) / Q) mod t, with s the
ternary secret key. Products in Z_q[x]/(x^N + 1) go through a textbook
negacyclic NTT (the twist by a primitive 2N-th root psi, a radix-2
Cooley-Tukey transform of length N, the untwist); the scale by t / Q sums
the CRT terms ((x_i (Q/q_i)^-1) mod q_i) t / q_i in float64, whose error
(below 2^-30 for t < 2^20 and k < 64) is far inside the distance to the
rounding boundary of any ciphertext that decrypts at all.
"""

from __future__ import annotations

import torch


def _root(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod the prime q (order a power
    of two dividing q - 1)."""
    if (q - 1) % order:
        raise ValueError(f"{q} has no {order}-th roots of unity")
    for g in range(2, q):
        r = pow(g, (q - 1) // order, q)
        if pow(r, order // 2, q) == q - 1:
            return r
    raise ValueError(f"no primitive {order}-th root mod {q}")


def _powers(w: int, count: int, q: int) -> list[int]:
    out, x = [], 1
    for _ in range(count):
        out.append(x)
        x = x * w % q
    return out


class NegacyclicNtt:
    """Negacyclic products in Z_q[x]/(x^N + 1) for several primes at once:
    tensors [..., k, N], one row a prime."""

    def __init__(self, n: int, moduli, device):
        if n & (n - 1):
            raise ValueError("N must be a power of two")
        self.n, self.moduli = n, tuple(int(q) for q in moduli)
        k = len(self.moduli)

        def col(rows):
            return torch.tensor(rows, dtype=torch.int64, device=device)

        self.q = col(self.moduli).reshape(k, 1)
        psis = [_root(q, 2 * n) for q in self.moduli]
        self.twist = col([_powers(p, n, q) for p, q in zip(psis, self.moduli)])
        self.untwist = col([
            [x * pow(n, -1, q) % q for x in _powers(pow(p, -1, q), n, q)]
            for p, q in zip(psis, self.moduli)])
        bits = n.bit_length() - 1
        self.bitrev = torch.tensor(
            [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
             for i in range(n)], dtype=torch.int64, device=device)
        self.fwd_tw, self.inv_tw = [], []
        m = 1
        while m < n:
            for tables, sign in ((self.fwd_tw, 1), (self.inv_tw, -1)):
                tables.append(col([
                    _powers(pow(p * p % q, sign * (n // (2 * m)), q), m, q)
                    for p, q in zip(psis, self.moduli)]))
            m *= 2

    def _cyclic(self, a, tables):
        lead, k, n = a.shape[:-2], a.shape[-2], self.n
        q = self.q.reshape(k, 1, 1)
        a = a[..., self.bitrev]
        m = 1
        for tw in tables:
            a = a.reshape(*lead, k, n // (2 * m), 2, m)
            u = a[..., 0, :]
            v = a[..., 1, :] * tw.reshape(k, 1, m) % q
            a = torch.stack(((u + v) % q, (u - v) % q), dim=-2)
            m *= 2
        return a.reshape(*lead, k, n)

    def forward(self, a):
        """Coefficients [..., k, N] (any integers) -> evaluations."""
        return self._cyclic(a % self.q * self.twist % self.q, self.fwd_tw)

    def inverse(self, a_hat):
        return self._cyclic(a_hat, self.inv_tw) * self.untwist % self.q

    def multiply(self, a, b):
        """a b mod (x^N + 1, q) for every prime, [..., k, N]."""
        return self.inverse(self.forward(a) * self.forward(b) % self.q)


class Decryptor:
    """BFV decryption under the ternary secret key `s` ([N], values -1, 0,
    1) for the moduli `moduli` and the plain modulus t."""

    def __init__(self, s, moduli, t: int):
        s = torch.as_tensor(s).to(torch.int64)
        self.ntt = NegacyclicNtt(s.shape[-1], moduli, s.device)
        self.t = int(t)
        big_q = 1
        for q in self.ntt.moduli:
            big_q *= q
        self.crt = torch.tensor([pow(big_q // q, -1, q)
                                 for q in self.ntt.moduli],
                                dtype=torch.int64,
                                device=s.device).reshape(-1, 1)
        self.s_hat = self.ntt.forward(s.unsqueeze(0).expand(
            len(self.ntt.moduli), -1))

    def phase(self, ct):
        """c0 + c1 s mod Q as residues [..., k, N]."""
        q = self.ntt.q
        c1s = self.ntt.inverse(self.ntt.forward(ct[..., 1, :, :])
                               * self.s_hat % q)
        return (ct[..., 0, :, :] + c1s) % q

    def decrypt(self, ct):
        """[..., 2, k, N] -> plaintext coefficients [..., N] in [0, t)."""
        a = self.phase(ct) * self.crt % self.ntt.q
        terms = a.to(torch.float64) * self.t / self.ntt.q.to(torch.float64)
        v = terms.sum(-2)
        v = v - self.t * torch.floor(v / self.t)
        return torch.round(v).to(torch.int64) % self.t


def negacyclic_mod_t(a, b, t: int):
    """The plaintext product a b in Z_t[x]/(x^N + 1), t a prime = 1 mod 2N:
    [..., N] each."""
    ntt = NegacyclicNtt(a.shape[-1], (t,), a.device)
    return ntt.multiply(a.unsqueeze(-2), b.unsqueeze(-2)).squeeze(-2)


def wrong_coefficients(got, want) -> int:
    """How many plaintext coefficients differ."""
    return int((got != want).sum())


def row_rotation_element(steps: int, n: int) -> int:
    """The Galois element of a cyclic rotation of the batching rows by
    `steps` slots (SEAL's convention): 3^steps mod 2N."""
    return pow(3, steps % (n // 2), 2 * n)


def column_swap_element(n: int) -> int:
    return 2 * n - 1


def automorphism(p, g: int, t: int):
    """p(x) -> p(x^g) in Z_t[x]/(x^N + 1) for odd g: [..., N] each."""
    n = p.shape[-1]
    e = torch.arange(n, device=p.device) * g % (2 * n)
    out = torch.empty_like(p)
    out[..., e % n] = torch.where(e >= n, (t - p) % t, p)
    return out

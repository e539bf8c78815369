"""R1CS Bulletproofs: constraint system + prover + verifier.

Replaces the reference's `sunscreen_bulletproofs` fork (dalek
bulletproofs with the `yoloproofs` R1CS feature) consumed by
`sunscreen_zkp_backend/src/bulletproofs.rs:24-180`. Same protocol
structure (Pedersen-committed witnesses, multiplier gates
a_L ∘ a_R = a_O, flattened linear constraints, degree-6 t-polynomial,
inner-product argument), same transcript label schedule; multiplier
count is padded to a power of two with explicit zero gates.

Port of `sunscreen_tpu/zk/r1cs.py`. Two additions: the prover draws its
blindings from an explicit source of scalars (`scalar_source`: the OS's
`secrets` by default, a seeded `random.Random` in tests), where the
reference calls `secrets.randbelow` itself, and prover and verifier pass
their `device` on to every `cv.msm` (on a CUDA device, from n = 1024
gates, the prover's A_I1 and S1 commitments of 2n + 1 points, the
verifier's combined commitment of 2n + 5 and the IPP's final multiexp of
2n + 2 log2 n + 1 run on the card).

Constraint relation: for each constraint q,
  sum_i wL[q][i]*a_L[i] + wR[q][i]*a_R[i] + wO[q][i]*a_O[i]
    + sum_j wV[q][j]*v_j + c_q = 0.
"""

from __future__ import annotations

import random
import secrets
from dataclasses import dataclass
from typing import Callable

from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import ipp
from sunscreen_tpu_torch.zk.merlin import Transcript
from sunscreen_tpu_torch.zk.pedersen import cached_bp_gens, cached_pedersen

L = cv.L


def scalar_source(seed: int | None = None) -> Callable[[], int]:
    """A callable drawing uniform scalars mod L: from the OS (`secrets`)
    when seed is None, else from `random.Random(seed)`, a deterministic
    TEST-ONLY mode."""
    if seed is None:
        return lambda: secrets.randbelow(L)
    rng = random.Random(seed)
    return lambda: rng.randrange(L)


@dataclass(frozen=True)
class Variable:
    """kind: 'committed' (index into v), 'mult_l'/'mult_r'/'mult_o'
    (index into gates), or 'one'."""

    kind: str
    index: int = 0

    @staticmethod
    def one() -> "Variable":
        return Variable("one")


class LinearCombination:
    """Sparse sum of (Variable, scalar) terms (dalek `LinearCombination`)."""

    def __init__(self, terms=None):
        self.terms: list[tuple[Variable, int]] = list(terms or [])

    @staticmethod
    def from_variable(v: Variable) -> "LinearCombination":
        return LinearCombination([(v, 1)])

    @staticmethod
    def constant(c: int) -> "LinearCombination":
        return LinearCombination([(Variable.one(), c % L)])

    def __add__(self, other):
        other = _coerce_lc(other)
        return LinearCombination(self.terms + other.terms)

    def __sub__(self, other):
        other = _coerce_lc(other)
        return LinearCombination(
            self.terms + [(v, (-s) % L) for v, s in other.terms])

    def __neg__(self):
        return LinearCombination([(v, (-s) % L) for v, s in self.terms])

    def scale(self, k: int) -> "LinearCombination":
        return LinearCombination([(v, s * k % L) for v, s in self.terms])


def _coerce_lc(x) -> LinearCombination:
    if isinstance(x, LinearCombination):
        return x
    if isinstance(x, Variable):
        return LinearCombination.from_variable(x)
    return LinearCombination.constant(int(x))


@dataclass
class R1CSProof:
    A_I1: cv.Point
    A_O1: cv.Point
    S1: cv.Point
    T_1: cv.Point
    T_3: cv.Point
    T_4: cv.Point
    T_5: cv.Point
    T_6: cv.Point
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: ipp.InnerProductProof

    def to_bytes(self) -> bytes:
        pts = [self.A_I1, self.A_O1, self.S1, self.T_1, self.T_3,
               self.T_4, self.T_5, self.T_6]
        out = b"".join(p.encode() for p in pts)
        out += b"".join(cv.scalar_to_bytes(s) for s in
                        (self.t_x, self.t_x_blinding, self.e_blinding))
        out += len(self.ipp_proof.L_vec).to_bytes(4, "little")
        for L_pt, R_pt in zip(self.ipp_proof.L_vec, self.ipp_proof.R_vec):
            out += L_pt.encode() + R_pt.encode()
        out += cv.scalar_to_bytes(self.ipp_proof.a)
        out += cv.scalar_to_bytes(self.ipp_proof.b)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        """Raises `cv.DecodeError` on truncated input, absurd round
        counts, or non-canonical point/scalar encodings (including
        response scalars >= L, which would otherwise make the encoding
        malleable)."""
        if len(data) < 8 * 32 + 3 * 32 + 4:
            raise cv.DecodeError("truncated R1CS proof")
        pts = [cv.decode(data[i * 32:(i + 1) * 32]) for i in range(8)]
        off = 8 * 32
        sc = [cv.scalar_from_canonical_bytes(
            data[off + i * 32: off + (i + 1) * 32]) for i in range(3)]
        off += 3 * 32
        lg = int.from_bytes(data[off:off + 4], "little")
        off += 4
        if lg > 64:
            raise cv.DecodeError("implausible round count")
        if len(data) != off + 64 * lg + 64:
            raise cv.DecodeError("R1CS proof length mismatch")
        Ls, Rs = [], []
        for _ in range(lg):
            Ls.append(cv.decode(data[off:off + 32]))
            Rs.append(cv.decode(data[off + 32:off + 64]))
            off += 64
        a = cv.scalar_from_canonical_bytes(data[off:off + 32])
        b = cv.scalar_from_canonical_bytes(data[off + 32:off + 64])
        return R1CSProof(*pts, *sc, ipp.InnerProductProof(Ls, Rs, a, b))


class _ConstraintSystem:
    """Shared constraint bookkeeping for prover and verifier."""

    def __init__(self):
        self.constraints: list[LinearCombination] = []
        self.num_gates = 0
        self.num_committed = 0

    def constrain(self, lc: LinearCombination):
        self.constraints.append(_coerce_lc(lc))

    # -- flattening ----------------------------------------------------------

    def _flattened(self, z: int, n: int, m: int):
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m
        wc = 0
        exp_z = z
        for con in self.constraints:
            for var, coeff in con.terms:
                if var.kind == "mult_l":
                    wL[var.index] = (wL[var.index] + exp_z * coeff) % L
                elif var.kind == "mult_r":
                    wR[var.index] = (wR[var.index] + exp_z * coeff) % L
                elif var.kind == "mult_o":
                    wO[var.index] = (wO[var.index] + exp_z * coeff) % L
                elif var.kind == "committed":
                    # committed weights accumulate negatively: the
                    # relation is wL.aL + wR.aR + wO.aO = wV.v + c, so
                    # t_2 = delta - wc + <wV, v> with this sign
                    wV[var.index] = (wV[var.index] - exp_z * coeff) % L
                else:  # constant
                    wc = (wc + exp_z * coeff) % L
            exp_z = exp_z * z % L
        return wL, wR, wO, wV, wc


class Prover(_ConstraintSystem):
    def __init__(self, transcript: Transcript, device=None,
                 rand_scalar: Callable[[], int] | None = None):
        super().__init__()
        self.transcript = transcript
        self.device = device
        self._rand_scalar = rand_scalar or scalar_source()
        transcript.append_message(b"dom-sep", b"r1cs v1")
        self.pc = cached_pedersen()
        self.v: list[int] = []
        self.v_blinding: list[int] = []
        self.a_L: list[int] = []
        self.a_R: list[int] = []
        self.a_O: list[int] = []

    def commit(self, value: int, blinding: int | None = None
               ) -> tuple[cv.Point, Variable]:
        blinding = self._rand_scalar() if blinding is None else blinding
        V = self.pc.commit(value % L, blinding)
        self.transcript.append_point(b"V", V)
        self.v.append(value % L)
        self.v_blinding.append(blinding)
        self.num_committed += 1
        return V, Variable("committed", len(self.v) - 1)

    def eval_lc(self, lc: LinearCombination) -> int:
        total = 0
        for var, coeff in lc.terms:
            if var.kind == "committed":
                val = self.v[var.index]
            elif var.kind == "mult_l":
                val = self.a_L[var.index]
            elif var.kind == "mult_r":
                val = self.a_R[var.index]
            elif var.kind == "mult_o":
                val = self.a_O[var.index]
            else:
                val = 1
            total = (total + val * coeff) % L
        return total

    def multiply(self, left, right):
        """Allocate a multiplier gate bound to the two LCs."""
        left = _coerce_lc(left)
        right = _coerce_lc(right)
        l_val = self.eval_lc(left)
        r_val = self.eval_lc(right)
        i = self.num_gates
        self.num_gates += 1
        self.a_L.append(l_val)
        self.a_R.append(r_val)
        self.a_O.append(l_val * r_val % L)
        lv = Variable("mult_l", i)
        rv = Variable("mult_r", i)
        ov = Variable("mult_o", i)
        self.constrain(left - lv)
        self.constrain(right - rv)
        return lv, rv, ov

    def allocate_multiplier(self, l_val: int, r_val: int):
        """Unbound gate with explicit assignments (dalek
        `allocate_multiplier`)."""
        i = self.num_gates
        self.num_gates += 1
        self.a_L.append(l_val % L)
        self.a_R.append(r_val % L)
        self.a_O.append(l_val * r_val % L)
        return (Variable("mult_l", i), Variable("mult_r", i),
                Variable("mult_o", i))

    def prove(self) -> R1CSProof:
        t = self.transcript
        # pad gates to a power of two with zero gates
        n = max(1, self.num_gates)
        padded_n = 1 << (n - 1).bit_length()
        while self.num_gates < padded_n:
            self.allocate_multiplier(0, 0)
        n = padded_n
        m = len(self.v)
        bp = cached_bp_gens(n)
        G, H = bp.G[:n], bp.H[:n]
        Bb = self.pc.B_blinding

        t.append_u64(b"m", m)
        i_blinding = self._rand_scalar()
        o_blinding = self._rand_scalar()
        s_blinding = self._rand_scalar()
        s_L = [self._rand_scalar() for _ in range(n)]
        s_R = [self._rand_scalar() for _ in range(n)]
        dev = self.device
        A_I = cv.msm([i_blinding] + self.a_L + self.a_R, [Bb] + G + H, dev)
        A_O = cv.msm([o_blinding] + self.a_O, [Bb] + G, dev)
        S = cv.msm([s_blinding] + s_L + s_R, [Bb] + G + H, dev)
        t.append_point(b"A_I1", A_I)
        t.append_point(b"A_O1", A_O)
        t.append_point(b"S1", S)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")
        wL, wR, wO, wV, _wc = self._flattened(z, n, m)

        exp_y = [pow(y, i, L) for i in range(n)]
        y_inv = cv.scalar_inv(y)
        exp_y_inv = [pow(y_inv, i, L) for i in range(n)]

        # l(X), r(X): degree-3 vector polynomials
        l1 = [(self.a_L[i] + exp_y_inv[i] * wR[i]) % L for i in range(n)]
        l2 = list(self.a_O)
        l3 = list(s_L)
        r0 = [(wO[i] - exp_y[i]) % L for i in range(n)]
        r1 = [(exp_y[i] * self.a_R[i] + wL[i]) % L for i in range(n)]
        r3 = [exp_y[i] * s_R[i] % L for i in range(n)]

        def ip(u, w):
            return sum(a * b for a, b in zip(u, w)) % L

        # t(X) = <l(X), r(X)>, degrees 1..6 (l0 = r2 = 0)
        t1 = ip(l1, r0)
        t2 = (ip(l1, r1) + ip(l2, r0)) % L
        t3 = (ip(l2, r1) + ip(l3, r0)) % L
        t4 = (ip(l3, r1) + ip(l1, r3)) % L
        t5 = (ip(l2, r3)) % L
        t6 = (ip(l3, r3)) % L

        t1_b = self._rand_scalar()
        t3_b = self._rand_scalar()
        t4_b = self._rand_scalar()
        t5_b = self._rand_scalar()
        t6_b = self._rand_scalar()
        T_1 = self.pc.commit(t1, t1_b)
        T_3 = self.pc.commit(t3, t3_b)
        T_4 = self.pc.commit(t4, t4_b)
        T_5 = self.pc.commit(t5, t5_b)
        T_6 = self.pc.commit(t6, t6_b)
        for lbl, pt in ((b"T_1", T_1), (b"T_3", T_3), (b"T_4", T_4),
                        (b"T_5", T_5), (b"T_6", T_6)):
            t.append_point(lbl, pt)

        _u = t.challenge_scalar(b"u")  # phase separator (no 2nd phase)
        x = t.challenge_scalar(b"x")

        # t_2 blinding comes from the committed values' blindings
        t2_b = ip(wV, self.v_blinding)
        t_x = (t1 * x + t2 * pow(x, 2, L) + t3 * pow(x, 3, L)
               + t4 * pow(x, 4, L) + t5 * pow(x, 5, L)
               + t6 * pow(x, 6, L)) % L
        t_x_blinding = (t1_b * x + t2_b * pow(x, 2, L)
                        + t3_b * pow(x, 3, L) + t4_b * pow(x, 4, L)
                        + t5_b * pow(x, 5, L) + t6_b * pow(x, 6, L)) % L
        e_blinding = (x * i_blinding + pow(x, 2, L) * o_blinding
                      + pow(x, 3, L) * s_blinding) % L

        l_vec = [(l1[i] * x + l2[i] * pow(x, 2, L)
                  + l3[i] * pow(x, 3, L)) % L for i in range(n)]
        r_vec = [(r0[i] + r1[i] * x + r3[i] * pow(x, 3, L)) % L
                 for i in range(n)]

        t.append_scalar(b"t_x", t_x)
        t.append_scalar(b"t_x_blinding", t_x_blinding)
        t.append_scalar(b"e_blinding", e_blinding)
        w = t.challenge_scalar(b"w")
        Q = self.pc.B * w

        ipp_proof = ipp.create(
            t, Q, [1] * n, exp_y_inv, G, H, l_vec, r_vec, dev)
        return R1CSProof(A_I, A_O, S, T_1, T_3, T_4, T_5, T_6,
                         t_x, t_x_blinding, e_blinding, ipp_proof)


class Verifier(_ConstraintSystem):
    def __init__(self, transcript: Transcript, device=None):
        super().__init__()
        self.transcript = transcript
        self.device = device
        transcript.append_message(b"dom-sep", b"r1cs v1")
        self.pc = cached_pedersen()
        self.V: list[cv.Point] = []

    def commit(self, commitment: cv.Point) -> Variable:
        self.transcript.append_point(b"V", commitment)
        self.V.append(commitment)
        self.num_committed += 1
        return Variable("committed", len(self.V) - 1)

    def multiply(self, left, right):
        left = _coerce_lc(left)
        right = _coerce_lc(right)
        i = self.num_gates
        self.num_gates += 1
        lv = Variable("mult_l", i)
        rv = Variable("mult_r", i)
        ov = Variable("mult_o", i)
        self.constrain(left - lv)
        self.constrain(right - rv)
        return lv, rv, ov

    def allocate_multiplier(self):
        i = self.num_gates
        self.num_gates += 1
        return (Variable("mult_l", i), Variable("mult_r", i),
                Variable("mult_o", i))

    def verify(self, proof: R1CSProof) -> bool:
        t = self.transcript
        n = max(1, self.num_gates)
        padded_n = 1 << (n - 1).bit_length()
        while self.num_gates < padded_n:
            self.allocate_multiplier()
        n = padded_n
        if len(proof.ipp_proof.L_vec) != n.bit_length() - 1:
            return False
        m = len(self.V)
        bp = cached_bp_gens(n)
        G, H = bp.G[:n], bp.H[:n]
        B, Bb = self.pc.B, self.pc.B_blinding

        t.append_u64(b"m", m)
        t.append_point(b"A_I1", proof.A_I1)
        t.append_point(b"A_O1", proof.A_O1)
        t.append_point(b"S1", proof.S1)
        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")
        wL, wR, wO, wV, wc = self._flattened(z, n, m)
        for lbl, pt in ((b"T_1", proof.T_1), (b"T_3", proof.T_3),
                        (b"T_4", proof.T_4), (b"T_5", proof.T_5),
                        (b"T_6", proof.T_6)):
            t.append_point(lbl, pt)
        _u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")
        t.append_scalar(b"t_x", proof.t_x)
        t.append_scalar(b"t_x_blinding", proof.t_x_blinding)
        t.append_scalar(b"e_blinding", proof.e_blinding)
        w = t.challenge_scalar(b"w")
        Q = B * w

        exp_y = [pow(y, i, L) for i in range(n)]
        y_inv = cv.scalar_inv(y)
        exp_y_inv = [pow(y_inv, i, L) for i in range(n)]

        def ip(u, v):
            return sum(a * b for a, b in zip(u, v)) % L

        # check 1: t(x) commitment
        delta = ip([exp_y_inv[i] * wR[i] % L for i in range(n)], wL)
        x2 = pow(x, 2, L)
        rhs = cv.msm(
            [(x2 * ((delta - wc) % L)) % L]
            + [x2 * wv % L for wv in wV]
            + [x % L, pow(x, 3, L), pow(x, 4, L), pow(x, 5, L),
               pow(x, 6, L)],
            [B] + self.V
            + [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6],
            self.device)
        lhs = self.pc.commit(proof.t_x, proof.t_x_blinding)
        if lhs != rhs:
            return False

        # check 2: the IPP against the combined circuit commitment
        # P = x*A_I + x^2*A_O + x^3*S + <x*y^-n.wR, G>
        #     + <y^-n.(x*wL + wO) - 1, H> - e_blinding*Bb + t_x*Q
        g_exp = [x * exp_y_inv[i] % L * wR[i] % L for i in range(n)]
        h_exp = [(exp_y_inv[i] * ((x * wL[i] + wO[i]) % L) - 1) % L
                 for i in range(n)]
        P = cv.msm(
            [x, x2, pow(x, 3, L)] + g_exp + h_exp
            + [(-proof.e_blinding) % L, proof.t_x % L],
            [proof.A_I1, proof.A_O1, proof.S1] + G + H + [Bb, Q],
            self.device)
        return ipp.verify(proof.ipp_proof, n, t, [1] * n, exp_y_inv,
                          P, Q, G, H, self.device)

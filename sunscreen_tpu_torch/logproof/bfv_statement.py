"""SDLP statements over BFV ciphertexts (port of
`sunscreen_tpu/logproof/bfv_statement.py`).

Replaces `logproof/src/bfv_statement.rs:36-80`: builds the lattice
linear relation A·S = T directly from BFV ciphertexts so an SDLP can
prove "this ciphertext validly encrypts a message under these keys /
decrypts to this message". The Δ-scaling round(Q·m/t) is linearized as
Δ·m + r with the rounding remainder r a separate bounded witness
column (reference `compute_a`: the "r block").

Rows (per statement):
  PublicKeyEncryption: c0 = Δ·m + r + p0·u + e0 ; c1 = p1·u + e1
  PrivateKeyEncryption: c0 = Δ·m + r + c1·(-s) + (-e)
  Decryption:           c0 = Δ·m + r + c1·(-s) + (-e), |e| < Δ/2

Ciphertexts, keys and witnesses may be torch tensors on any device or
numpy arrays; the statement is host integers. A public key's components
come out of the NTT domain through the context's own plan (its mode's
layout), so the statement is the same polynomial whatever the mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from sunscreen_tpu_torch.bfv.context import BfvContext
from sunscreen_tpu_torch.logproof.lattice import ceil_log2
from sunscreen_tpu_torch.logproof.linear_relation import (ProverKnowledge,
                                                          VerifierKnowledge)

CBD_BOUND_BITS = 5  # |e| <= 21 (CBD(21)) < 2^5


@dataclass
class PublicKeyEncryptionStatement:
    message_id: int
    ct: np.ndarray          # [2, k, N] int64 (RNS residues)
    pk: object              # bfv.keys.PublicKey (NTT domain)


@dataclass
class PrivateKeyEncryptionStatement:
    message_id: int
    ct: np.ndarray


@dataclass
class DecryptionStatement:
    message_id: int
    ct: np.ndarray


@dataclass
class StatementWitness:
    """Per-statement secret data (reference `BfvWitness`)."""

    # public-key statements: (u, e0, e1) small signed polys
    u: np.ndarray | None = None
    e0: np.ndarray | None = None
    e1: np.ndarray | None = None
    # private-key/decryption statements: s (ternary) and e
    s: np.ndarray | None = None
    e: np.ndarray | None = None


def _host(x) -> np.ndarray:
    """A tensor on any device or an array, as a host int64 array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _rns_to_int_poly(ctx: BfvContext, residues) -> list[int]:
    """[k, N] residues -> N python ints in [0, Q)."""
    return ctx.q_base.compose(_host(residues))


def _ntt_pk_to_coeff(ctx: BfvContext, pk_comp) -> list[int]:
    """A public-key component out of the context's NTT domain."""
    coeff = ctx.plan_q.inv(torch.as_tensor(_host(pk_comp),
                                           device=ctx.device))
    return _rns_to_int_poly(ctx, coeff)


def _lift_t(c: int, t: int) -> int:
    """Centered representative of c mod t (digit lift)."""
    return c - t if c > t // 2 else c


def _signed_poly_bounds(bits: int, d: int) -> list[int]:
    return [bits] * d


@dataclass
class BfvStatements:
    """Accumulates statements + witnesses, then produces SDLP prover /
    verifier knowledge (reference: `generate_prover_knowledge`)."""

    ctx: BfvContext
    statements: list = field(default_factory=list)
    witnesses: list = field(default_factory=list)
    messages: list = field(default_factory=list)  # uint64 [N] polys < t
    # per-message (bound_bits | None, degree_bound | None) overrides
    message_bounds: list = field(default_factory=list)

    def add_message(self, pt, bound_bits: int | None = None,
                    degree_bound: int | None = None) -> int:
        """Register a message polynomial. `bound_bits` bounds each
        centered coefficient's magnitude (default: full plaintext
        range); `degree_bound` constrains coefficients at index >=
        degree_bound to ZERO (0-bit bounds), shrinking the binary
        expansion — the reference's `Link::DEGREE_BOUND` mechanism
        (`sunscreen_runtime/src/builder.rs:243-259,947-951`)."""
        self.messages.append(_host(pt).astype(np.uint64))
        self.message_bounds.append((bound_bits, degree_bound))
        return len(self.messages) - 1

    def add_public_encryption(self, message_id: int, ct, pk, u, e0, e1):
        self.statements.append(
            PublicKeyEncryptionStatement(message_id, _host(ct), pk))
        self.witnesses.append(StatementWitness(
            u=_host(u), e0=_host(e0), e1=_host(e1)))

    def add_private_encryption(self, message_id: int, ct, s, e):
        self.statements.append(
            PrivateKeyEncryptionStatement(message_id, _host(ct)))
        self.witnesses.append(StatementWitness(s=_host(s), e=_host(e)))

    def add_decryption(self, message_id: int, ct, secret_key):
        """Statement that `ct` decrypts to the identified message under
        `secret_key` (reference: `BfvProofStatement::Decryption`). The
        decryption error witness e = c0 + c1*s - Δm - r is computed
        here; its bound is Δ/2 (correct decryption)."""
        ct = _host(ct)
        s = _host(secret_key.s)
        e = self._decryption_error(ct, s, self.messages[message_id])
        self.statements.append(
            DecryptionStatement(message_id, ct))
        # relation row uses c1*(-s) + (-e); store positives, negated in
        # build like private encryption — but note decryption has
        # e = c(s) - Δm - r, so the row needs -(-e) ... keep the same
        # sign convention by storing -e directly
        self.witnesses.append(StatementWitness(s=s, e=-e))
        return e

    def _decryption_error(self, ct, s, msg) -> np.ndarray:
        """e over Z with |e| < Δ/2, from exact host arithmetic."""
        ctx = self.ctx
        q = ctx.params.q_product
        t = ctx.t
        d = ctx.n
        delta = q // t
        q_mod_t = q % t
        c0 = _rns_to_int_poly(ctx, ct[0])
        c1 = _rns_to_int_poly(ctx, ct[1])
        s_l = [int(x) for x in s]
        # c0 + c1*s mod (X^d + 1, q)
        acc = [0] * d
        for i, ci in enumerate(c1):
            for j, sj in enumerate(s_l):
                k = i + j
                if k < d:
                    acc[k] += ci * sj
                else:
                    acc[k - d] -= ci * sj
        v = [(a + b) % q for a, b in zip(c0, acc)]
        e = np.empty(d, dtype=np.int64)
        for i in range(d):
            m_i = int(msg[i])
            r_i = ((q_mod_t * m_i) * 2 + t) // (2 * t)
            lift = (v[i] - delta * m_i - r_i) % q
            if lift > q // 2:
                lift -= q
            e[i] = lift
        return e

    # -- assembly ------------------------------------------------------------

    def _layout(self):
        """Column layout: messages | remainder per statement | per-
        statement witness blocks."""
        n_msg = len(self.messages)
        cols = []
        col_of_remainder = {}
        col_of_witness = {}
        next_col = n_msg
        for si, st in enumerate(self.statements):
            col_of_remainder[si] = next_col
            next_col += 1
            if isinstance(st, PublicKeyEncryptionStatement):
                col_of_witness[si] = (next_col, next_col + 1, next_col + 2)
                next_col += 3  # u, e0, e1
            else:
                col_of_witness[si] = (next_col, next_col + 1)
                next_col += 2  # -s, -e
        return n_msg, col_of_remainder, col_of_witness, next_col

    def build(self, message_bound_bits: int | None = None
              ) -> tuple[VerifierKnowledge, ProverKnowledge]:
        ctx = self.ctx
        q = ctx.params.q_product
        t = ctx.t
        d = ctx.n
        delta = q // t
        q_mod_t = q % t
        n_msg, rem_col, wit_col, n_cols = self._layout()
        msg_bits = (message_bound_bits
                    or max(1, (t - 1).bit_length()))
        rem_bits = max(2, (t - 1).bit_length())

        rows_a: list[list[list[int]]] = []
        rows_t: list[list[int]] = []
        s_cols: list[list[int] | None] = [None] * n_cols
        bounds_cols: list[list[int] | None] = [None] * n_cols

        def zero():
            return [0]

        def set_s(col, poly_signed, bits):
            s_cols[col] = [c % q for c in poly_signed]
            bounds_cols[col] = _signed_poly_bounds(bits, d)

        # message + remainder witness columns. Message coefficients are
        # stored CENTERED (lift mod t): digit c > t/2 becomes c - t, and
        # the q_mod_t*1 shift moves into the rounding remainder (since
        # delta*t = q - q_mod_t). This is what lets signed digit
        # encodings (Signed/BfvSigned links) use a 1-magnitude-bit
        # bound and makes the linked value sum lift(c_j)*2^j a LINEAR
        # function of the s_1 bits (the reference instead remaps
        # in-circuit via SignedModulus — `bfv_plaintext.rs:95-107`).
        for mi, msg in enumerate(self.messages):
            mb, db = self.message_bounds[mi]
            bits = mb if mb is not None else msg_bits
            s_cols[mi] = [_lift_t(int(c), t) % q for c in msg]
            per_coeff = _signed_poly_bounds(bits, d)
            if db is not None:
                if any(int(c) for c in msg[db:]):
                    raise ValueError(
                        "message exceeds its declared degree bound")
                per_coeff = per_coeff[:db] + [0] * (d - db)
            bounds_cols[mi] = per_coeff
        for si, st in enumerate(self.statements):
            msg = self.messages[st.message_id]
            r = [((q_mod_t * int(c)) * 2 + t) // (2 * t)
                 - (q_mod_t if int(c) > t // 2 else 0) for c in msg]
            set_s(rem_col[si], r, rem_bits)

        for si, st in enumerate(self.statements):
            wit = self.witnesses[si]
            ct0 = _rns_to_int_poly(ctx, st.ct[0])
            ct1 = _rns_to_int_poly(ctx, st.ct[1])
            if isinstance(st, PublicKeyEncryptionStatement):
                p0 = _ntt_pk_to_coeff(ctx, st.pk.p0)
                p1 = _ntt_pk_to_coeff(ctx, st.pk.p1)
                cu, ce0, ce1 = wit_col[si]
                # row: c0 = Δ m + r + p0 u + e0
                row = [zero() for _ in range(n_cols)]
                row[st.message_id] = [delta % q]
                row[rem_col[si]] = [1]
                row[cu] = p0
                row[ce0] = [1]
                rows_a.append(row)
                rows_t.append(ct0)
                # row: c1 = p1 u + e1
                row = [zero() for _ in range(n_cols)]
                row[cu] = p1
                row[ce1] = [1]
                rows_a.append(row)
                rows_t.append(ct1)
                set_s(cu, [int(x) for x in wit.u], 1)
                set_s(ce0, [int(x) for x in wit.e0], CBD_BOUND_BITS)
                set_s(ce1, [int(x) for x in wit.e1], CBD_BOUND_BITS)
            else:
                cs, ce = wit_col[si]
                # row: c0 = Δ m + r + c1*(-s) + (-e)
                row = [zero() for _ in range(n_cols)]
                row[st.message_id] = [delta % q]
                row[rem_col[si]] = [1]
                row[cs] = ct1
                row[ce] = [1]
                rows_a.append(row)
                rows_t.append(ct0)
                if isinstance(st, DecryptionStatement):
                    e_bits = max(2, ceil_log2(delta // 2))
                else:
                    e_bits = CBD_BOUND_BITS
                set_s(cs, [-int(x) for x in wit.s], 1)
                set_s(ce, [-int(x) for x in wit.e], e_bits)

        f = [1] + [0] * (d - 1) + [1]
        a_mat = [[p for p in row] for row in rows_a]
        t_mat = [[p] for p in rows_t]
        bounds = [[bounds_cols[c]] for c in range(n_cols)]
        vk = VerifierKnowledge(
            a=a_mat, t=t_mat, bounds=bounds, f=f, q=q,
            n_messages=n_msg)
        s_mat = [[s_cols[c]] for c in range(n_cols)]
        return vk, ProverKnowledge(vk, s_mat)

"""Linked proofs: one SDLP + one Bulletproofs R1CS proof constraining
THE SAME message (port of `sunscreen_tpu/runtime/linked.py`).

Replaces `sunscreen_runtime/src/linked.rs` (`Sdlp`, `LinkedProof`) and
the `LogProofBuilder` fluent API (`src/builder.rs:397-900`:
`encrypt_returning_link`, zkp_program linking, build). The reference
links by sharing Pedersen generators between the SDLP commitment and a
forked bulletproofs; here the link is an explicit O(log l) compressed
bridge (two zero-knowledge inner-product proofs — see
`CompressedBridge`) proving that the bits committed in the SDLP's
`w_shared` (with generators h_shared) are EXACTLY the Bulletproofs
witness: for typed `Linked[...]` programs the bits ride as uncommitted
low-level BP wires bound through A_I1; for plain-Field programs they
recompose — under public 2's-complement weights — to the values inside
the BP's committed inputs V_j. Equivalent guarantee (same message
proven valid-encrypted and constrained by the R1CS), different
mechanism; documented delta from the reference.

Signed messages: digit encodings with digits in {-1, 0, 1} (the
Signed/Unsigned64 fresh encodings, negative values included) link via
centered digit lifts — the field value is sum lift(c_j)*2^j mod L and
the bit weights are the 2's-complement pair [1, -2] per coefficient,
the same recombination the reference's `BfvSigned` ZKP type performs
in-circuit (`types/zkp/bfv_plaintext.rs:64-128`). `reencrypt` and
`decrypt_returning_link` mirror the reference builder's
`reencrypt`/`decrypt_returning_msg` (builder.rs:397-900).

The port proves and verifies on the runtime's device (CUDA by default):
there, every MSM of at least 2048 points runs the CUDA Pippenger M1. The
builder encrypts through `bfv/ops.encrypt_return_components` with the
runtime's sampler (`sampling.key_from_seed`) and draws every blinding
scalar of a build from one source, `rand_scalar` (the OS by default): a
seeded source gives byte-identical proofs.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.bfv import ops as bops
from sunscreen_tpu_torch.bfv.params import BfvParams
from sunscreen_tpu_torch.logproof import bfv_statement as bstmt
from sunscreen_tpu_torch.logproof import inner_product as lp_ipp
from sunscreen_tpu_torch.logproof import linear_relation as lr
from sunscreen_tpu_torch.logproof.lattice import twos_complement_coeffs
from sunscreen_tpu_torch.math import sampling
from sunscreen_tpu_torch.runtime.runtime import Ciphertext
from sunscreen_tpu_torch.types.bfv_types import resolve_type
from sunscreen_tpu_torch.types.zkp_types import _bits_per_coeff
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import native
from sunscreen_tpu_torch.zk.backend import (BulletproofsBackend,
                                            BulletproofsProof)
from sunscreen_tpu_torch.zk.merlin import Transcript
from sunscreen_tpu_torch.zk.pedersen import cached_bp_gens, cached_pedersen
from sunscreen_tpu_torch.zk.r1cs import scalar_source

L = cv.L
SDLP_TRANSCRIPT_LABEL = b"sunscreen_tpu sdlp"


@dataclass
class LinkedMessage:
    """Handle to a message shared between the SDLP and a zkp program
    (reference: `LinkedMessage`, builder.rs:278-293).

    Consumed in one of two link styles, resolved at `build_linked` from
    the zkp program's signature:
    - typed `Linked[BfvSigned...]` args (reference parity): the
      message's SDLP expansion BITS become the program's first private
      inputs and the circuit recombines them (`message_ids` may span
      two polynomials for `BfvRational`);
    - plain `Field` args (compact variant): the recombined field
      `value` is the private input and `weights` recombine
      out-of-circuit inside the bridge.
    """

    message_id: int
    value: int            # field value fed to the zkp program
    weights: list[int]    # bit weights mod L over the message's s_1 bits
    message_ids: tuple[int, ...] = ()   # all polys (Rational: (num, den))
    type_name: str = "Signed"

    def __post_init__(self):
        if not self.message_ids:
            self.message_ids = (self.message_id,)


@dataclass
class Sdlp:
    """A standalone SDLP over BFV statements (reference: `Sdlp`
    struct), verified on `device` (the builder's) unless told otherwise."""

    proof: lr.LogProof
    vk: lr.VerifierKnowledge
    device: object = None

    def verify(self, device=None) -> bool:
        gens = _cached_generators(self.vk.l)
        return lr.verify(self.proof, Transcript(SDLP_TRANSCRIPT_LABEL),
                         self.vk, gens.g, gens.h, lp_ipp.get_u(),
                         gens=gens, device=_device(device, self.device))


@dataclass
class CompressedBridge:
    """O(log l) bridge binding w_shared's bits to the BP witness via
    two zero-knowledge inner-product proofs (the SDLP's own IPP,
    `logproof/inner_product.py`), replacing the earlier generalized
    Schnorr whose response vectors were O(l) scalars plus one 32-byte
    commitment per shared bit.

    `mode == "wires"` (typed `Linked[...]` programs): the shared bits
    are UNCOMMITTED low-level BP wires packed into A_I1 (no per-bit V
    commitments at all). `ipp_shared` proves, against
    t = w_shared + A_I1 + <v2_pub, h_bridge>, knowledge of an opening
    (bits ‖ i_blinding ‖ a_L ‖ a_R) over (h_shared ‖ Bb ‖ G ‖ H) with
    <opening, v2_pub> = 0 where v2_pub holds the powers r^i on the
    h_shared slots and -r^i on the wire slot carrying bit i. The
    challenge r is drawn AFTER both w_shared and the complete BP proof
    are in the transcript, so bits-in-w_shared == bits-in-A_I1 follows
    from Schwartz–Zippel over r.

    `mode == "values"` (plain `Field` programs): the linked field
    values stay Pedersen-committed (V_j). `ipp_shared` proves, against
    t = w_shared + Σ c_j·V_j + <v2_pub, h_bridge>, an opening
    (bits ‖ Σc_j·v_j ‖ Σc_j·r_j) over (h_shared ‖ B ‖ Bb) with inner
    product Σ_j c_j·(<bits_j, weights_j> - v_j) = 0, the c_j drawn
    after all commitments (random-linear-combination soundness).

    Both modes carry `ipp_unshared`: a compressed PoK of an opening of
    w - w_shared over the RESTRICTED set (h_unshared, g, u) — the
    degenerate IPP with v_2 = 0 and identity right-generators. Summed
    with ipp_shared's half this yields an opening of the SDLP
    commitment w over the full independent generator set; by Pedersen
    binding it must coincide with the (s_1, s_2, rho) opening the SDLP
    extractor produces, so the bridged h_shared exponents ARE the
    SDLP's shared s_1 bits. Without this half a prover could split w
    arbitrarily and 'link' an unrelated value. Binding across proofs holds because h/g (SDLP shake
    chains 'g'/'h'), the BP's G/H/B/Bb, u, and the bridge h_bridge
    ('bridge-h' chain) are all independently hash-derived generators.
    The reference gets the same guarantee by embedding the shared
    generators in the BP's G vector and checking
    A_I1_shared == w_shared (`sunscreen_runtime/src/linked.rs:285`);
    this bridge keeps the stock BP generator set instead and pays two
    log-size IPPs.
    """

    mode: str                               # "wires" | "values"
    ipp_shared: lp_ipp.InnerProductProof
    ipp_unshared: lp_ipp.InnerProductProof

    def to_bytes(self) -> bytes:
        m = self.mode.encode()
        sh = self.ipp_shared.to_bytes()
        return (len(m).to_bytes(1, "little") + m
                + len(sh).to_bytes(4, "little") + sh
                + self.ipp_unshared.to_bytes())

    @staticmethod
    def from_bytes(data: bytes) -> "CompressedBridge":
        ml = data[0]
        mode = data[1:1 + ml].decode()
        off = 1 + ml
        shl = int.from_bytes(data[off:off + 4], "little")
        off += 4
        return CompressedBridge(
            mode, lp_ipp.InnerProductProof.from_bytes(data[off:off + shl]),
            lp_ipp.InnerProductProof.from_bytes(data[off + shl:]))


@dataclass
class LinkedProof:
    """SDLP + R1CS + bridge (reference: `LinkedProof`,
    linked.rs:32-52). For typed `Linked[...]` programs the shared bits
    are uncommitted low-level BP wires bound through A_I1 ("wires"
    bridge); for plain-Field programs the recombined values are the
    BP's first committed inputs ("values" bridge)."""

    sdlp: lr.LogProof
    vk: lr.VerifierKnowledge
    message_ids: list[int]   # linked message columns, one per poly
    bp_proof: BulletproofsProof
    bridge: CompressedBridge
    params: object = None   # BfvParams when the program has linked args
    device: object = None   # where verify runs unless told (not serialized)

    @property
    def shared_slices(self) -> list[tuple[int, int]]:
        """Bit ranges of the linked polynomials inside s_1 — DERIVED
        from the verified statement (vk) and the linked message ids,
        never trusted from prover-supplied proof fields."""
        all_slices = self.vk.b_slices()
        return [all_slices[mid][0] for mid in self.message_ids]

    def size_bytes(self) -> dict:
        """Per-component serialized sizes (the bridge is O(log l);
        the reference's whole LinkedProof is likewise log-size,
        `sunscreen_runtime/src/linked.rs`)."""
        return {"sdlp": len(self.sdlp.to_bytes()),
                "bp": len(self.bp_proof.to_bytes()),
                "bridge": len(self.bridge.to_bytes())}

    def to_bytes(self) -> bytes:
        """Wire format for the PROOF only (reference: serde on
        `LinkedProof`). The verifier's statement knowledge (vk) is
        deliberately NOT serialized — `from_bytes` takes it from the
        verifying application, matching the trust model verify()
        enforces."""
        mids = struct.pack("<I", len(self.message_ids)) + b"".join(
            struct.pack("<q", int(m)) for m in self.message_ids)
        if self.params is None:
            pb = struct.pack("<I", 0)
        else:
            p = self.params
            body = struct.pack(
                "<QQIQ", p.poly_degree, p.plain_modulus,
                len(p.coeff_modulus), p.special_modulus) + b"".join(
                struct.pack("<Q", q) for q in p.coeff_modulus) + \
                struct.pack("<I", p.security_level)
            pb = struct.pack("<I", len(body)) + body
        sd = self.sdlp.to_bytes()
        bp = self.bp_proof.to_bytes()
        br = self.bridge.to_bytes()
        return (mids + pb
                + struct.pack("<I", len(sd)) + sd
                + struct.pack("<I", len(bp)) + bp
                + struct.pack("<I", len(br)) + br)

    @staticmethod
    def from_bytes(data: bytes, vk: lr.VerifierKnowledge, device=None
                   ) -> "LinkedProof":
        """Deserialize against the VERIFIER'S statement knowledge, to be
        verified on `device`. Raises `cv.DecodeError` on malformed input
        (the component decoders validate canonical encodings)."""
        off = 0

        def take(n):
            nonlocal off
            if off + n > len(data):
                raise cv.DecodeError("truncated linked proof")
            out = data[off:off + n]
            off += n
            return out

        (n_mids,) = struct.unpack("<I", take(4))
        if n_mids > 1 << 20:
            raise cv.DecodeError("implausible message id count")
        mids = [struct.unpack("<q", take(8))[0] for _ in range(n_mids)]
        (plen,) = struct.unpack("<I", take(4))
        params = None
        if plen:
            body = take(plen)
            if plen < 28:
                raise cv.DecodeError("truncated params block")
            pd, pm, nq, sp = struct.unpack("<QQIQ", body[:28])
            if nq > 1 << 16:
                raise cv.DecodeError("implausible modulus count")
            if plen != 28 + 8 * nq + 4:
                raise cv.DecodeError("malformed params block length")
            qs = struct.unpack(f"<{nq}Q", body[28:28 + 8 * nq])
            (sec,) = struct.unpack("<I", body[28 + 8 * nq:])
            params = BfvParams(pd, pm, tuple(qs), sp, sec)
        (n,) = struct.unpack("<I", take(4))
        sdlp = lr.LogProof.from_bytes(take(n))
        (n,) = struct.unpack("<I", take(4))
        bp = BulletproofsProof.from_bytes(take(n))
        (n,) = struct.unpack("<I", take(4))
        bridge = CompressedBridge.from_bytes(take(n))
        if off != len(data):
            raise cv.DecodeError("trailing bytes in linked proof")
        return LinkedProof(sdlp, vk, mids, bp, bridge, params=params,
                           device=device)

    def verify(self, zkp_program, public_inputs=(),
               constant_inputs=(), expected_message_ids=None,
               expected_link_count=None, params=None, device=None) -> bool:
        """Pass `expected_message_ids` to pin WHICH statement messages
        the zkp program's inputs are linked to (applications verifying
        against specific ciphertexts should check this; the ids index
        the statements in `vk`). Programs WITHOUT typed `Linked[...]`
        args (compact values mode) additionally REQUIRE either
        `expected_message_ids` or `expected_link_count` — the program
        signature cannot reveal how many of its private inputs are
        linked, so an unpinned count would let a prover choose it.
        `params`: the verifying application's BfvParams; when omitted
        for typed-link programs, the proof's embedded params are used
        but cross-checked against the verified statement (q, degree).
        `device`: where the MSMs run (default: the proof's)."""
        device = _device(device, self.device)
        mids = list(self.message_ids)
        if (expected_message_ids is not None
                and list(expected_message_ids) != mids):
            return False
        # -- structural validation of the prover-supplied message_ids:
        # duplicates would alias h_shared generators,
        # reducing Pedersen binding to the SUM of the duplicated
        # openings; out-of-range / non-message ids must fail closed.
        all_slices = self.vk.b_slices()
        limit = (self.vk.n_messages if self.vk.n_messages is not None
                 else len(all_slices))
        if len(set(mids)) != len(mids):
            return False
        if any(not isinstance(m, int) or isinstance(m, bool)
               or not 0 <= m < limit for m in mids):
            return False
        gens = _cached_generators(self.vk.l)
        u = lp_ipp.get_u()
        # 1. the SDLP
        if not lr.verify(self.sdlp, Transcript(SDLP_TRANSCRIPT_LABEL),
                         self.vk, gens.g, gens.h, u, gens=gens,
                         device=device):
            return False
        # slices + recombination weights derive from vk (canonical
        # 2's-complement), NOT from prover-controlled proof fields
        slices = [all_slices[mid][0] for mid in mids]
        n_bits = sum(hi - lo for lo, hi in slices)
        # 2. the R1CS proof
        backend = BulletproofsBackend()
        if getattr(zkp_program, "linked_types", None):
            if self.bridge.mode != "wires":
                return False
            p = params if params is not None else self.params
            if p is None:
                return False
            # cross-check (possibly prover-supplied) params against the
            # verified statement so the circuit's recombination
            # semantics cannot be redefined: q and
            # poly degree must match vk, and each linked polynomial's
            # slice width must equal the typed arg's bit layout under
            # these params. That pins ceil_log2(t) + the degree bounds
            # — the ONLY channels through which params enter the traced
            # circuit (see _BfvPlaintextNode: recombination weights are
            # pure 2's-complement over the bit grid).
            if (getattr(p, "q_product", None) != self.vk.q
                    or getattr(p, "poly_degree", None) != self.vk.d):
                return False
            want_widths = []
            for lt in zkp_program.linked_types:
                d_bound = min(lt.DEGREE_BOUND, p.poly_degree)
                want_widths.extend(
                    [d_bound * _bits_per_coeff(p.plain_modulus)]
                    * lt.N_POLYS)
            if [hi - lo for lo, hi in slices] != want_widths:
                return False
            # consistency with the statement: every linked message
            # column must appear in some row with coefficient Δ = q//t
            # (pins t to Δ's floor window; exact when q > t^2)
            delta = (self.vk.q // p.plain_modulus) % self.vk.q
            for mid in mids:
                if not any(row[mid] == [delta] for row in self.vk.a):
                    return False
            prog = zkp_program.build(params=p)
            lowlevel = n_bits
            weights = []
        else:
            if self.bridge.mode != "values":
                return False
            if expected_message_ids is None:
                if expected_link_count is None:
                    return False   # fail closed: link count unpinned
                if len(mids) != expected_link_count:
                    return False
            prog = zkp_program.build()
            lowlevel = 0
            weights = [_canonical_weights(hi - lo) for lo, hi in slices]
        if not backend.verify(prog, self.bp_proof, public_inputs,
                              constant_inputs, device=device,
                              lowlevel_prefix=lowlevel):
            return False
        # 3. the bridge
        if self.bridge.mode == "values":
            if len(self.bp_proof.commitments) < len(slices):
                return False
        return _verify_bridge(self.bridge, self.sdlp.w_shared,
                              self.sdlp.w, self.bp_proof,
                              slices, weights, gens, u, self.vk.l, device)


def _device(device, default):
    """The device of a verification: the caller's, else the proof's, else
    CUDA (`resolve_device`)."""
    return resolve_device(device if device is not None else default)


_GEN_CACHE: dict[int, lr.LogProofGenerators] = {}


def _cached_generators(l: int) -> lr.LogProofGenerators:
    if l not in _GEN_CACHE:
        _GEN_CACHE[l] = lr.LogProofGenerators(l)
    return _GEN_CACHE[l]


# -- the compressed bridge ----------------------------------------------------

_BRIDGE_H: list = []   # prefix-stable shake chain, grown on demand


def _bridge_h(count: int):
    """Independent right-side generators for the shared-half IPP
    (shake chain label 'bridge-h', disjoint from the SDLP's 'g'/'h'
    chains and the BP generators)."""
    global _BRIDGE_H
    if len(_BRIDGE_H) < count:
        _BRIDGE_H = lr.generators(count, b"bridge-h")
    return _BRIDGE_H[:count]


def _bridge_transcript(w_shared, w, bp_proof, slices, mode) -> Transcript:
    """Fiat–Shamir base for the bridge challenges: binds the SDLP
    commitments, the COMPLETE BP proof (so A_I1 / the V_j are fixed
    before r / c_j are drawn), and the slice structure."""
    t = Transcript(b"sunscreen_tpu linked bridge v2")
    t.append_message(b"mode", mode.encode())
    t.append_point(b"w_shared", w_shared)
    t.append_point(b"w", w)
    t.append_message(b"bp",
                     hashlib.sha3_256(bp_proof.to_bytes()).digest())
    for lo, hi in slices:
        t.append_u64(b"lo", lo)
        t.append_u64(b"hi", hi)
    return t


def _powers(x: int, count: int) -> list[int]:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * x % L
    return out


def _wires_v2(t: Transcript, n_bits: int, n_gates: int) -> list[int]:
    """Public right vector for the wires-mode shared IPP over
    g = (h_shared ‖ Bb ‖ G ‖ H): r-powers on the bit slots, -r^i on the
    a_L/a_R wire slot holding bit i (bits packed two per gate, gates
    first — BulletproofsBackend.lowlevel_var layout)."""
    r = t.challenge_scalar(b"r")
    rpow = _powers(r, n_bits)
    m_L = [(-rpow[2 * g]) % L if 2 * g < n_bits else 0
           for g in range(n_gates)]
    m_R = [(-rpow[2 * g + 1]) % L if 2 * g + 1 < n_bits else 0
           for g in range(n_gates)]
    return rpow + [0] + m_L + m_R


def _values_v2(t: Transcript, slices, weights):
    """Public right vector for the values-mode shared IPP over
    g = (h_shared ‖ B ‖ Bb): c_j-scaled recombination weights on the
    bit slots, -1 on the B slot (which carries Σ c_j·v_j)."""
    cs = [t.challenge_scalar(b"c") for _ in slices]
    v2 = []
    for j, (lo, hi) in enumerate(slices):
        v2.extend(cs[j] * w_ % L for w_ in weights[j][:hi - lo])
    return v2 + [(-1) % L, 0], cs


def _unshared_vectors(gens, slices, l):
    shared_idx = set()
    for lo, hi in slices:
        shared_idx.update(range(lo, hi))
    g_un = [gens.h[i] for i in range(l) if i not in shared_idx] \
        + list(gens.g)
    return g_un, shared_idx


def _unshared_buffers(gens, slices, l):
    """(g_un_buf, count, h_id_buf): cached-buffer form of the
    unshared-half generator set (h outside the shared ranges ++ g) —
    at production l the python Point marshalling otherwise dominates
    the bridge. Padded to the IPP's power of two."""
    if native.get_lib() is None:
        return None, 0, None
    mask = np.ones(l, dtype=bool)
    for lo, hi in slices:
        mask[lo:hi] = False
    hb = np.frombuffer(gens.h_buf, np.uint8).reshape(l, 128)
    buf = hb[mask].tobytes() + gens.g_buf
    count = int(mask.sum()) + l
    target = 1 << max(0, (count - 1).bit_length())
    buf = buf + lr.IDENTITY_BUF * (target - count)
    h_id = lr.IDENTITY_BUF * target
    return buf, count, h_id


def _prove_bridge_wires(bits, s_1, half_rho, w_shared, w, bp_proof,
                        witness, slices, gens, u, device, rand
                        ) -> CompressedBridge:
    pc = cached_pedersen()
    n = witness["n"]
    bp = cached_bp_gens(n)
    h_shared, _ = _split_h(gens, slices)
    t = _bridge_transcript(w_shared, w, bp_proof, slices, "wires")
    v2 = _wires_v2(t, len(bits), n)
    g_vec = h_shared + [pc.B_blinding] + bp.G[:n] + bp.H[:n]
    v1 = list(bits) + [witness["i_blinding"]] \
        + witness["a_L"] + witness["a_R"]
    if sum(a * b for a, b in zip(v1, v2)) % L:
        raise RuntimeError("bridge identity failed (bit/wire mismatch)")
    h_vec = _bridge_h(len(v2))
    t_sh = w_shared + bp_proof.r1cs.A_I1 + cv.msm(v2, h_vec, device)
    ipp_sh = lp_ipp.create(t, v1, v2, half_rho, t_sh, g_vec, h_vec, u,
                           rand_fn=rand, device=device)
    ipp_un = _prove_unshared(t, s_1, half_rho, w_shared, w, slices,
                             gens, u, device, rand)
    return CompressedBridge("wires", ipp_sh, ipp_un)


def _prove_bridge_values(bits, s_1, half_rho, values, blindings,
                         w_shared, w, bp_proof, slices, weights, gens,
                         u, device, rand) -> CompressedBridge:
    pc = cached_pedersen()
    h_shared, _ = _split_h(gens, slices)
    t = _bridge_transcript(w_shared, w, bp_proof, slices, "values")
    v2, cs = _values_v2(t, slices, weights)
    g_vec = h_shared + [pc.B, pc.B_blinding]
    v_agg = sum(c_ * v_ for c_, v_ in zip(cs, values)) % L
    r_agg = sum(c_ * r_ for c_, r_ in zip(cs, blindings)) % L
    v1 = list(bits) + [v_agg, r_agg]
    if sum(a * b for a, b in zip(v1, v2)) % L:
        raise RuntimeError("bridge identity failed (weighted "
                           "recombination mismatch)")
    h_vec = _bridge_h(len(v2))
    vs = bp_proof.commitments[:len(slices)]
    t_sh = w_shared + cv.msm(cs, vs, device) + cv.msm(v2, h_vec, device)
    ipp_sh = lp_ipp.create(t, v1, v2, half_rho, t_sh, g_vec, h_vec, u,
                           rand_fn=rand, device=device)
    ipp_un = _prove_unshared(t, s_1, half_rho, w_shared, w, slices,
                             gens, u, device, rand)
    return CompressedBridge("values", ipp_sh, ipp_un)


def _prove_unshared(t, s_1, half_rho, w_shared, w, slices, gens, u,
                    device, rand):
    """Compressed PoK of an opening of w - w_shared over the RESTRICTED
    set (h_unshared, g, u): the ZK IPP degenerates (v_2 = 0, identity
    right-generators) into a log-size proof of opening — binding on
    the left generators alone pins the exponents."""
    l = len(s_1)
    shared_idx = set()
    for lo, hi in slices:
        shared_idx.update(range(lo, hi))
    s_2 = [1 - b for b in s_1]
    v1 = [s_1[i] for i in range(l) if i not in shared_idx] + s_2
    v2 = [0] * len(v1)
    t_un = w + w_shared * (L - 1)   # w - w_shared
    g_buf, count, h_id_buf = _unshared_buffers(gens, slices, l)
    if g_buf is not None:
        return lp_ipp.create(t, v1, v2, half_rho, t_un, None, None, u,
                             rand_fn=rand, g_buf=g_buf, h_buf=h_id_buf,
                             device=device)
    g_un, _ = _unshared_vectors(gens, slices, l)
    h_id = [cv.IDENTITY] * len(v1)
    return lp_ipp.create(t, v1, v2, half_rho, t_un, g_un, h_id, u,
                         rand_fn=rand, device=device)


def _canonical_weights(width: int) -> list[int]:
    """Canonical 2's-complement recombination weights for a values-mode
    link: bound-1 messages serialize to 2 bits/coefficient, coefficient
    c contributes lift(digit_c)·2^c (the layout `_link_message`
    produces). Recomputed by the VERIFIER from the slice width so a
    prover cannot substitute weights."""
    tc = twos_complement_coeffs(2)
    return [(1 << c) * w % L for c in range(width // 2) for w in tc]


def _split_h(gens, slices):
    """(h_shared, h_unshared) — generators inside/outside the shared
    bit ranges, each in ascending index order."""
    shared_idx = set()
    for lo, hi in slices:
        shared_idx.update(range(lo, hi))
    h_shared = []
    for lo, hi in slices:
        h_shared.extend(gens.h[lo:hi])
    h_unshared = [p for i, p in enumerate(gens.h) if i not in shared_idx]
    return h_shared, h_unshared


def _verify_bridge(br: CompressedBridge, w_shared, w, bp_proof, slices,
                   weights, gens, u, l, device) -> bool:
    pc = cached_pedersen()
    h_shared, _ = _split_h(gens, slices)
    n_bits = len(h_shared)
    t = _bridge_transcript(w_shared, w, bp_proof, slices, br.mode)
    if br.mode == "wires":
        n = 1 << len(bp_proof.r1cs.ipp_proof.L_vec)
        bp = cached_bp_gens(n)
        v2 = _wires_v2(t, n_bits, n)
        g_vec = h_shared + [pc.B_blinding] + bp.G[:n] + bp.H[:n]
        t_sh = w_shared + bp_proof.r1cs.A_I1
    else:
        v2, cs = _values_v2(t, slices, weights)
        g_vec = h_shared + [pc.B, pc.B_blinding]
        vs = bp_proof.commitments[:len(slices)]
        t_sh = w_shared + cv.msm(cs, vs, device)
    if len(v2) != len(g_vec):
        return False
    h_vec = _bridge_h(len(v2))
    t_sh = t_sh + cv.msm(v2, h_vec, device)
    if not lp_ipp.verify(br.ipp_shared, t, t_sh, 0, g_vec, h_vec, u,
                         device=device):
        return False
    t_un = w + w_shared * (L - 1)   # w - w_shared
    g_buf, count, h_id_buf = _unshared_buffers(gens, slices, l)
    if g_buf is not None:
        return lp_ipp.verify(br.ipp_unshared, t, t_un, 0, None, None,
                             u, g_buf=g_buf[:count * 128],
                             h_buf=h_id_buf[:count * 128], device=device)
    g_un, _ = _unshared_vectors(gens, slices, l)
    h_id = [cv.IDENTITY] * len(g_un)
    return lp_ipp.verify(br.ipp_unshared, t, t_un, 0, g_un, h_id, u,
                         device=device)


# -- builder -----------------------------------------------------------------

class LogProofBuilder:
    """Fluent builder (reference: `LogProofBuilder` /
    `LinkedProofBuilder`): encrypt messages while capturing SDLP
    statements, optionally returning links, then build an `Sdlp` or a
    `LinkedProof` on the runtime's device. `rand_scalar` draws every
    blinding scalar of a build (`r1cs.scalar_source()`, the OS, by
    default)."""

    def __init__(self, runtime, rand_scalar=None):
        self.rt = runtime
        self.ctx = runtime.ctx
        self.device = runtime.device
        self._rand = rand_scalar or scalar_source()
        self.statements = bstmt.BfvStatements(self.ctx)
        self._links: list[LinkedMessage] = []
        self._msg_bound_bits: dict[int, int] = {}

    # -- encryption capture --------------------------------------------------

    def encrypt(self, value, public_key, seed: int | None = None):
        """Encrypt + record a (non-linked) proof statement."""
        ct, _ = self._encrypt_internal(value, public_key, seed)
        return ct

    def encrypt_returning_link(self, value, public_key,
                               seed: int | None = None):
        """Encrypt + record a statement + return a LinkedMessage for use
        as a zkp program's first private inputs (reference:
        `encrypt_returning_link`, builder.rs:808)."""
        return self._encrypt_internal(value, public_key, seed,
                                      link=True)

    def _encode(self, value) -> np.ndarray:
        polys = type(value).encode(value.value, self.ctx.params,
                                   self.device)
        return np.asarray(polys).reshape(-1, self.ctx.n)

    def _encrypt_internal(self, value, public_key, seed, link=False):
        polys = self._encode(value)
        gen = sampling.key_from_seed(seed)
        encs = [bops.encrypt_return_components(
            self.ctx, public_key.public_key,
            torch.as_tensor(pt.astype(np.int64), device=self.device), gen)
            for pt in polys]
        return self._record_encryptions(
            type(value), polys, [ct for ct, _ in encs],
            [comps for _, comps in encs], public_key.public_key, link)

    def _record_encryptions(self, tcls, polys, cts, comps, pk, link):
        """Record one PublicKeyEncryption statement a plaintext polynomial:
        `cts` [2, k, N] and their components (u, e0, e1), tensors or
        arrays. Returns the typed ciphertext and, with `link`, its
        LinkedMessage."""
        mids = []
        for pt, ct, (u, e0, e1) in zip(polys, cts, comps):
            mid = self._add_message(pt)
            self.statements.add_public_encryption(mid, ct, pk, u, e0, e1)
            mids.append(mid)
        wrapped = Ciphertext(
            tcls._type_name(),
            [torch.as_tensor(bstmt._host(ct), device=self.device)
             for ct in cts], self.ctx.params)
        if not link:
            return wrapped, None
        if len(polys) not in (1, 2):
            raise ValueError("linked encryption supports 1- or 2-poly types")
        return wrapped, self._link_message(mids, polys, tcls.__name__)

    def _add_message(self, pt) -> int:
        """Register a message poly; signed ±1 digit encodings (Signed /
        Unsigned / negative values: the reference's `BfvSigned` /
        `BfvUnsigned64` linked types, `types/zkp/bfv_plaintext.rs`) fit
        the 1-magnitude-bit bound (2 bits with the sign bump)."""
        t = self.ctx.params.plain_modulus
        digits = bstmt._host(pt)
        if not np.all((digits <= 1) | (digits == t - 1)):
            raise ValueError(
                "linked messages must be fresh digit encodings with digits "
                "in {-1, 0, 1} (Signed/Unsigned64 encodings)")
        mid = self.statements.add_message(digits)
        self._msg_bound_bits[mid] = 1
        return mid

    def _link_message(self, mids, polys, type_name="Signed"
                      ) -> LinkedMessage:
        """Field value + bit weights for registered message(s). Value =
        sum_j lift(c_j) * 2^j mod L with centered digit lift (negative
        digits land as L - |v| in the field, matching the reference's
        2's-complement coefficient extraction + signed recombination,
        `bfv_plaintext.rs:64-128`)."""
        if isinstance(mids, int):
            mids = [mids]
            polys = bstmt._host(polys)[None, :]
        t = self.ctx.params.plain_modulus
        val = 0
        for i, c in enumerate(bstmt._host(polys[0])):
            d = int(c)
            if d > t // 2:
                d -= t
            val = (val + d * (1 << i)) % L
        tc = twos_complement_coeffs(2)  # 1-bit bound -> 2 bits signed
        weights = []
        for j in range(self.ctx.n):
            for w in tc:
                weights.append((1 << j) * w % L)
        msg = LinkedMessage(mids[0], val, weights,
                            message_ids=tuple(mids),
                            type_name=type_name)
        self._links.append(msg)
        return msg

    # -- decryption / reencryption capture ----------------------------------

    def _decrypt_recorded(self, ct, private_key):
        """(raw ciphertext, plaintext, message id) of a single-ciphertext
        value, with a Decryption statement recorded against it."""
        if len(ct.cts) != 1:
            raise ValueError("single-ciphertext types only")
        raw = ct.cts[0]
        pt = bops.decrypt(self.ctx, private_key.sk,
                          raw.to(self.device)).cpu().numpy()
        mid = self._add_message(pt)
        self.statements.add_decryption(mid, raw, private_key.sk)
        return raw, pt, mid

    def decrypt_returning_link(self, ct, private_key):
        """Decrypt + record a Decryption statement + return a
        LinkedMessage for the decrypted value (reference:
        `decrypt_returning_msg`, builder.rs:397-900)."""
        _, pt, mid = self._decrypt_recorded(ct, private_key)
        value = resolve_type(ct.type_name).decode(pt, self.ctx.params,
                                                  self.device)
        return value, self._link_message(mid, pt)

    def reencrypt(self, ct, private_key, public_key,
                  seed: int | None = None, link: bool = True):
        """Prove `new_ct` encrypts THE SAME message `ct` decrypts to:
        records one shared message with both a Decryption statement (old
        ct) and a PublicKeyEncryption statement (new ct) against it
        (reference: `LogProofBuilder::reencrypt`, builder.rs:397-900).
        Returns (new_ct, LinkedMessage | None)."""
        _, pt, mid = self._decrypt_recorded(ct, private_key)
        new_raw, (u, e0, e1) = bops.encrypt_return_components(
            self.ctx, public_key.public_key,
            torch.as_tensor(pt.astype(np.int64), device=self.device),
            sampling.key_from_seed(seed))
        self.statements.add_public_encryption(
            mid, new_raw, public_key.public_key, u, e0, e1)
        wrapped = Ciphertext(ct.type_name, [new_raw], self.ctx.params)
        if not link:
            return wrapped, None
        return wrapped, self._link_message(mid, pt)

    # -- builds --------------------------------------------------------------

    def _prover_knowledge(self):
        return self.statements.build(message_bound_bits=1)

    def _sdlp(self, pk_know, half_rho, shared_cols):
        gens = _cached_generators(pk_know.vk.l)
        return lr.create(
            Transcript(SDLP_TRANSCRIPT_LABEL), pk_know, gens.g, gens.h,
            lp_ipp.get_u(), half_rho=half_rho, shared_indices=shared_cols,
            gens=gens, device=self.device, rand_fn=self._rand)

    def build_sdlp(self) -> Sdlp:
        vk, pk_know = self._prover_knowledge()
        return Sdlp(self._sdlp(pk_know, None, None), vk, self.device)

    def build_linked(self, zkp_program, extra_private_inputs=(),
                     public_inputs=(), constant_inputs=()
                     ) -> LinkedProof:
        """SDLP with shared message bits + BP proof whose first private
        inputs are the linked messages + bridge (reference:
        `LinkedProofBuilder::build`, builder.rs:445). Typed
        `Linked[BfvSigned...]` programs take the raw expansion bits
        in-circuit; plain-Field programs take the recombined value."""
        if getattr(zkp_program, "linked_types", None):
            return self._build_linked_circuit(
                zkp_program, extra_private_inputs, public_inputs,
                constant_inputs)
        vk, pk_know = self._prover_knowledge()
        gens = _cached_generators(vk.l)
        u = lp_ipp.get_u()
        half_rho = self._rand()
        sdlp_proof = self._sdlp(pk_know, half_rho,
                                [(m.message_id, 0) for m in self._links])
        slices = [vk.b_slices()[m.message_id][0] for m in self._links]

        # R1CS proof with the linked values first (committed inputs)
        values = [m.value for m in self._links]
        private = values + [int(x) for x in extra_private_inputs]
        bp_proof, blindings = BulletproofsBackend().prove_with_blindings(
            zkp_program.build(), private, [int(x) for x in public_inputs],
            [int(x) for x in constant_inputs], device=self.device,
            rand_scalar=self._rand)

        # bridge (canonical weights: the verifier re-derives them)
        s_1 = lr._binary_expand(vk, pk_know.s)
        bits = []
        for lo, hi in slices:
            bits.extend(s_1[lo:hi])
        weights = [_canonical_weights(hi - lo) for lo, hi in slices]
        bridge = _prove_bridge_values(
            bits, s_1, half_rho, values, blindings[:len(values)],
            sdlp_proof.w_shared, sdlp_proof.w, bp_proof, slices,
            weights, gens, u, self.device, self._rand)
        return LinkedProof(sdlp_proof, vk,
                           [m.message_id for m in self._links],
                           bp_proof, bridge, device=self.device)

    def _build_linked_circuit(self, zkp_program, extra_private_inputs,
                              public_inputs, constant_inputs
                              ) -> LinkedProof:
        """Typed in-circuit links: raise the linked message columns to
        full plaintext bounds with the type's degree bound, share their
        complete bit expansions, feed the bits as the BP's first
        private inputs (uncommitted low-level wires), and bind them to
        A_I1 with the O(log l) wires bridge (reference surface:
        `#[linked] x: BfvSigned`, `types/zkp/bfv_plaintext.rs` +
        `builder.rs:947-951`; mechanism delta from shared-generator
        A_I1 == w_shared, see `CompressedBridge` docstring)."""
        params = self.ctx.params
        t = params.plain_modulus
        linked_types = zkp_program.linked_types
        if len(linked_types) != len(self._links):
            raise ValueError(
                f"program has {len(linked_types)} linked args but "
                f"{len(self._links)} links were returned by the builder")
        compat = {"BfvSigned": ("Signed",),
                  "BfvUnsigned64": ("Unsigned64", "Unsigned"),
                  "BfvUnsigned128": ("Unsigned128",),
                  "BfvRational": ("Rational",)}
        bound = max(1, (t - 1).bit_length())
        for ltype, link in zip(linked_types, self._links):
            names = compat.get(ltype.__name__)
            if names and not any(link.type_name.startswith(nm)
                                 for nm in names):
                raise TypeError(
                    f"linked arg expects {ltype.__name__} but the "
                    f"builder linked a {link.type_name}")
            if ltype.N_POLYS != len(link.message_ids):
                raise TypeError(
                    f"{ltype.__name__} spans {ltype.N_POLYS} "
                    f"polynomials; link has {len(link.message_ids)}")
            d_bound = min(ltype.DEGREE_BOUND, params.poly_degree)
            for mid in link.message_ids:
                self.statements.message_bounds[mid] = (bound, d_bound)

        vk, pk_know = self._prover_knowledge()
        gens = _cached_generators(vk.l)
        u = lp_ipp.get_u()
        half_rho = self._rand()
        mids = [mid for m in self._links for mid in m.message_ids]
        sdlp_proof = self._sdlp(pk_know, half_rho,
                                [(mid, 0) for mid in mids])
        all_slices = vk.b_slices()
        msg_slices = [all_slices[mid][0] for mid in mids]

        # the shared bits, in slice order (coeff-major, LSB-first: the
        # same layout _LinkedTypeMeta.make_node nests)
        s_1 = lr._binary_expand(vk, pk_know.s)
        bits = []
        for lo, hi in msg_slices:
            bits.extend(s_1[lo:hi])

        # bits ride as UNCOMMITTED low-level wires (no per-bit V
        # commitments); the wires bridge binds them to A_I1
        private = bits + [int(x) for x in extra_private_inputs]
        bp_proof, _, witness = BulletproofsBackend().prove_with_witness(
            zkp_program.build(params=params), private,
            [int(x) for x in public_inputs],
            [int(x) for x in constant_inputs], lowlevel_prefix=len(bits),
            device=self.device, rand_scalar=self._rand)

        bridge = _prove_bridge_wires(
            bits, s_1, half_rho, sdlp_proof.w_shared, sdlp_proof.w,
            bp_proof, witness, msg_slices, gens, u, self.device,
            self._rand)
        return LinkedProof(sdlp_proof, vk, mids, bp_proof, bridge,
                           params=params, device=self.device)

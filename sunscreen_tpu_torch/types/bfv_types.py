"""FHE DSL types: encodings over BFV plaintext polynomials + operators
(port of `sunscreen_tpu/types/bfv_types.py`).

A type instance is either a trace handle (IR node ids while a program is
traced) or a value (a Python number or array to encrypt). The encodings
are host numpy, the reference's code: each `encode` returns numpy uint64
and takes the `device` of the caller, which only `Batched` uses, for the
port's `BatchEncoder` (kernels B1/B3 on a CUDA context).

Encodings:
  Signed      — binary expansion with sign applied per digit (digit in
                {0, 1, t-1}); decode reads digits centered mod t.
  Unsigned64  — plain binary expansion.
  Fractional  — fixed-point: integer bits at low coefficients, fractional
                bits at the top coefficients negated (x^N = -1 trick).
  Rational    — pair of Signed ciphertexts (num, den): enables division.
  Batched     — N SIMD slots via the batch encoder (2 x N/2 matrix).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sunscreen_tpu_torch.bfv import BatchEncoder, get_context
from sunscreen_tpu_torch.compiler.ir import Op
from sunscreen_tpu_torch.compiler.trace import current_ctx


class Cipher:
    """`Cipher[T]` annotation marker (reference: `Cipher<T>` marker type,
    `sunscreen/src/types/intern/`)."""

    def __class_getitem__(cls, inner):
        return _CipherAnnotation(inner)


class _CipherAnnotation:
    def __init__(self, inner):
        self.inner = inner

    def _type_name(self):
        return f"Cipher<{self.inner._type_name()}>"

    def _make_input(self, ctx, input_idx):
        n = self.inner.num_ciphertexts
        ids = tuple(ctx.emit(Op.INPUT_CIPHERTEXT, (), input_idx + j)
                    for j in range(n))
        return self.inner._from_ids(ids, cipher=True), n, True


class Array:
    """Fixed-size array program inputs (reference:
    `[Cipher<Signed>; N]` args, `sunscreen/tests/array.rs`): annotate
    as `Array[Cipher[Signed], 5]`. The traced handle is a python list
    of element handles — index and iterate freely."""

    def __class_getitem__(cls, item):
        inner, length = item
        return _ArrayAnnotation(inner, int(length))


class _ArrayAnnotation:
    def __init__(self, inner, length: int):
        assert length >= 1
        self.inner = inner
        self.length = length

    def _type_name(self):
        return f"[{self.inner._type_name()}; {self.length}]"

    def _make_input(self, ctx, input_idx):
        handles = []
        used = 0
        is_cipher = True
        for _ in range(self.length):
            h, n, is_cipher = self.inner._make_input(
                ctx, input_idx + used)
            used += n
            handles.append(h)
        return handles, used, is_cipher


def _is_handle(x):
    return isinstance(x, BfvType) and x._ids is not None


class BfvType:
    """Base: single-polynomial encodings. Subclasses set encode/decode."""

    num_ciphertexts = 1

    def __init__(self):
        self._ids: tuple[int, ...] | None = None
        self._cipher = False
        self.value = None

    # -- trace plumbing ------------------------------------------------------

    @classmethod
    def _type_name(cls):
        return cls.__name__

    @classmethod
    def _from_ids(cls, ids, cipher):
        obj = cls.__new__(cls)
        BfvType.__init__(obj)
        obj._ids = tuple(ids)
        obj._cipher = cipher
        return obj

    def _make_input(self, ctx, input_idx):
        raise TypeError("plaintext program inputs must use Cipher[...] or "
                        "be literals")

    @classmethod
    def _make_plain_input(cls, ctx, input_idx):
        ids = tuple(ctx.emit(Op.INPUT_PLAINTEXT, (), input_idx + j)
                    for j in range(cls.num_ciphertexts))
        return cls._from_ids(ids, cipher=False), cls.num_ciphertexts

    def _output_ids(self):
        if self._ids is None or not self._cipher:
            raise TypeError("fhe_program outputs must be ciphertexts")
        return self._ids

    # -- encoding API (implemented per subclass) -----------------------------

    @classmethod
    def encode(cls, value, params, device=None) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def decode(cls, poly: np.ndarray, params, device=None):
        raise NotImplementedError

    # -- operator helpers ----------------------------------------------------

    def _coerce(self, other):
        if isinstance(other, BfvType):
            if type(other) is not type(self):
                raise TypeError(
                    f"cannot mix {type(self).__name__} with "
                    f"{type(other).__name__}")
            return other
        # literal -> interned plaintext node
        ctx = current_ctx()
        poly = type(self).encode(other, ctx.params, ctx.device)
        lit = ctx.literal_plaintext(poly)
        return type(self)._from_ids((lit,), cipher=False)

    def _emit_bin(self, other, op_cc: Op, op_cp: Op, swap_ok: bool):
        other = self._coerce(other)
        ctx = current_ctx()
        a, b = self, other
        if a._cipher and b._cipher:
            out = ctx.emit(op_cc, (a._ids[0], b._ids[0]))
        elif a._cipher:
            out = ctx.emit(op_cp, (a._ids[0], b._ids[0]))
        elif b._cipher and swap_ok:
            out = ctx.emit(op_cp, (b._ids[0], a._ids[0]))
        else:
            raise TypeError("at least one operand must be a ciphertext, "
                            "and this op is not commutable")
        return type(self)._from_ids((out,), cipher=True)

    def __add__(self, other):
        return self._emit_bin(other, Op.ADD, Op.ADD_PLAIN, swap_ok=True)

    __radd__ = __add__

    def __mul__(self, other):
        return self._emit_bin(other, Op.MULTIPLY, Op.MULTIPLY_PLAIN,
                              swap_ok=True)

    __rmul__ = __mul__

    def __sub__(self, other):
        return self._emit_bin(other, Op.SUB, Op.SUB_PLAIN, swap_ok=False)

    def __rsub__(self, other):
        # plain - cipher = -(cipher - plain)
        return (self - other).__neg__()

    def __neg__(self):
        ctx = current_ctx()
        if not self._cipher:
            raise TypeError("negation requires a ciphertext")
        out = ctx.emit(Op.NEGATE, (self._ids[0],))
        return type(self)._from_ids((out,), cipher=True)


# --------------------------------------------------------------------------
# integer encodings
# --------------------------------------------------------------------------

def _signed_digits_decode(poly, t, weights):
    """Digits centered mod t, dotted with `weights` (python ints)."""
    total = 0
    for c, w in zip(poly.tolist(), weights):
        c = int(c)
        d = c - t if c > t // 2 else c
        total += d * w
    return total


class Signed(BfvType):
    """64-bit signed integer, binary digits with per-digit sign
    (reference: `sunscreen/src/types/bfv/signed.rs:31-155`)."""

    def __init__(self, value: int = 0):
        super().__init__()
        self.value = int(value)

    @classmethod
    def encode(cls, value, params, device=None):
        v = int(value)
        n = params.poly_degree
        t = params.plain_modulus
        poly = np.zeros(n, dtype=np.uint64)
        mag = abs(v)
        bits = min(mag.bit_length(), n)
        for i in range(bits):
            if (mag >> i) & 1:
                poly[i] = 1 if v >= 0 else t - 1
        return poly

    @classmethod
    def decode(cls, poly, params, device=None):
        t = params.plain_modulus
        weights = [1 << i for i in range(params.poly_degree)]
        return _signed_digits_decode(np.asarray(poly), t, weights)


class Unsigned64(BfvType):
    """64-bit unsigned integer (reference: `Unsigned<LIMBS>`,
    `unsigned.rs:33`). Decode is mod 2^64 like the reference's wrapping
    semantics."""

    def __init__(self, value: int = 0):
        super().__init__()
        self.value = int(value) & (2**64 - 1)

    @classmethod
    def encode(cls, value, params, device=None):
        v = int(value)
        assert v >= 0
        n = params.poly_degree
        poly = np.zeros(n, dtype=np.uint64)
        for i in range(min(v.bit_length(), n)):
            poly[i] = (v >> i) & 1
        return poly

    @classmethod
    def decode(cls, poly, params, device=None):
        t = params.plain_modulus
        weights = [1 << i for i in range(params.poly_degree)]
        return _signed_digits_decode(
            np.asarray(poly), t, weights) % (2**64)


class Unsigned(BfvType):
    """Generic unsigned integer of LIMBS 64-bit limbs (reference:
    `Unsigned<LIMBS>`, `types/bfv/unsigned.rs:33`): `Unsigned[2]` is
    the reference's `Unsigned128`. Binary digit encoding; decode wraps
    mod 2^(64*LIMBS) like the reference's wrapping semantics."""

    LIMBS = 1

    def __init__(self, value: int = 0):
        super().__init__()
        self.value = int(value) & ((1 << (64 * self.LIMBS)) - 1)

    _specializations: dict[int, type] = {}

    def __class_getitem__(cls, limbs):
        if limbs not in Unsigned._specializations:
            Unsigned._specializations[limbs] = type(
                f"Unsigned<{limbs}>", (cls,), {"LIMBS": limbs})
        return Unsigned._specializations[limbs]

    @classmethod
    def _type_name(cls):
        return f"Unsigned<{cls.LIMBS}>" if cls is not Unsigned \
            else "Unsigned"

    @classmethod
    def encode(cls, value, params, device=None):
        v = int(value)
        assert v >= 0
        n = params.poly_degree
        bits = 64 * cls.LIMBS
        assert n >= bits or v < (1 << n), "value exceeds ring capacity"
        poly = np.zeros(n, dtype=np.uint64)
        for i in range(min(v.bit_length(), min(bits, n))):
            poly[i] = (v >> i) & 1
        return poly

    @classmethod
    def decode(cls, poly, params, device=None):
        t = params.plain_modulus
        weights = [1 << i for i in range(params.poly_degree)]
        return _signed_digits_decode(
            np.asarray(poly), t, weights) % (1 << (64 * cls.LIMBS))


Unsigned128 = Unsigned[2]


class Fractional(BfvType):
    """Fixed-point real with INT_BITS integer bits (reference:
    `Fractional<INT_BITS>`, `fractional.rs:161`). Fractional bits live at
    the top coefficients, negated (since x^N = -1), so ct×ct multiply
    composes correctly without rescaling."""

    INT_BITS = 64

    def __init__(self, value: float = 0.0):
        super().__init__()
        self.value = float(value)

    _specializations: dict[int, type] = {}

    def __class_getitem__(cls, int_bits):
        if int_bits not in Fractional._specializations:
            Fractional._specializations[int_bits] = type(
                f"Fractional{int_bits}", (cls,), {"INT_BITS": int_bits})
        return Fractional._specializations[int_bits]

    @classmethod
    def encode(cls, value, params, device=None):
        v = float(value)
        n = params.poly_degree
        t = params.plain_modulus
        poly = np.zeros(n, dtype=np.uint64)
        neg = v < 0
        mag = abs(v)
        ipart = int(mag)
        frac = mag - ipart
        assert ipart < (1 << cls.INT_BITS), "integer part overflow"
        for i in range(min(ipart.bit_length(), cls.INT_BITS)):
            if (ipart >> i) & 1:
                poly[i] = t - 1 if neg else 1
        for j in range(1, n - cls.INT_BITS):
            frac *= 2
            if frac >= 1:
                frac -= 1
                # -2^-j at coeff n-j (sign flips through x^N = -1)
                poly[n - j] = 1 if neg else t - 1
            if frac == 0:
                break
        return poly

    @classmethod
    def decode(cls, poly, params, device=None):
        poly = np.asarray(poly)
        t = params.plain_modulus
        n = params.poly_degree
        total = 0.0
        for i in range(n):
            c = int(poly[i])
            if c == 0:
                continue
            d = c - t if c > t // 2 else c
            if i < cls.INT_BITS:
                total += d * float(2**i)
            else:
                total -= d * 2.0 ** -(n - i)
        return total

    def __truediv__(self, other):
        """cipher / plaintext-constant = multiply_plain by the encoded
        reciprocal (reference: `GraphCipherConstDiv for Fractional`,
        `sunscreen/src/types/bfv/fractional.rs:400-420`)."""
        if isinstance(other, BfvType):
            raise TypeError(
                "Fractional division only supports plaintext constants "
                "(use Rational for cipher/cipher division)")
        if not self._cipher:
            raise TypeError("constant division requires a ciphertext")
        ctx = current_ctx()
        lit = ctx.literal_plaintext(
            type(self).encode(1.0 / float(other), ctx.params,
                              ctx.device))
        out = ctx.emit(Op.MULTIPLY_PLAIN, (self._ids[0], lit))
        return type(self)._from_ids((out,), cipher=True)


class Rational(BfvType):
    """num/den pair of Signed ciphertexts — the only divisible type
    (reference: `rational.rs:18`)."""

    num_ciphertexts = 2

    def __init__(self, value: float = 0.0, denominator: int | None = None):
        super().__init__()
        if denominator is not None:
            self.value = (int(value), int(denominator))
        else:
            from fractions import Fraction
            f = Fraction(value).limit_denominator(1 << 31)
            self.value = (f.numerator, f.denominator)

    @classmethod
    def encode(cls, value, params, device=None):
        if isinstance(value, Rational):
            value = value.value
        if isinstance(value, tuple):
            n, d = value
        else:
            from fractions import Fraction
            f = Fraction(value).limit_denominator(1 << 31)
            n, d = f.numerator, f.denominator
        return np.stack([Signed.encode(n, params),
                         Signed.encode(d, params)])

    @classmethod
    def decode(cls, poly, params, device=None):
        n = Signed.decode(np.asarray(poly)[0], params)
        d = Signed.decode(np.asarray(poly)[1], params)
        if d == 0:
            raise ZeroDivisionError("rational denominator decodes to 0")
        from fractions import Fraction
        return Fraction(n, d)

    # -- operators: cross-multiply arithmetic ---------------------------------

    def _coerce_rat(self, other):
        if isinstance(other, Rational):
            return other
        if isinstance(other, BfvType):
            raise TypeError("cannot mix Rational with other FHE types")
        ctx = current_ctx()
        polys = Rational.encode(other, ctx.params, ctx.device)
        lit_n = ctx.literal_plaintext(polys[0])
        lit_d = ctx.literal_plaintext(polys[1])
        return Rational._from_ids((lit_n, lit_d), cipher=False)

    @staticmethod
    def _mul_nodes(ctx, a, ac, b, bc):
        if ac and bc:
            return ctx.emit(Op.MULTIPLY, (a, b)), True
        if ac:
            return ctx.emit(Op.MULTIPLY_PLAIN, (a, b)), True
        if bc:
            return ctx.emit(Op.MULTIPLY_PLAIN, (b, a)), True
        raise TypeError("plain*plain inside Rational op")

    def _cross(self, other, add: bool):
        other = self._coerce_rat(other)
        ctx = current_ctx()
        (n1, d1), c1 = self._ids, self._cipher
        (n2, d2), c2 = other._ids, other._cipher
        l, _ = self._mul_nodes(ctx, n1, c1, d2, c2)
        r, _ = self._mul_nodes(ctx, n2, c2, d1, c1)
        num = ctx.emit(Op.ADD if add else Op.SUB, (l, r))
        den, _ = self._mul_nodes(ctx, d1, c1, d2, c2)
        return Rational._from_ids((num, den), cipher=True)

    def __add__(self, other):
        return self._cross(other, add=True)

    __radd__ = __add__

    def __sub__(self, other):
        return self._cross(other, add=False)

    def __rsub__(self, other):
        return self._coerce_rat(other)._cross(self, add=False)

    def __mul__(self, other):
        other = self._coerce_rat(other)
        ctx = current_ctx()
        (n1, d1), c1 = self._ids, self._cipher
        (n2, d2), c2 = other._ids, other._cipher
        num, _ = self._mul_nodes(ctx, n1, c1, n2, c2)
        den, _ = self._mul_nodes(ctx, d1, c1, d2, c2)
        return Rational._from_ids((num, den), cipher=True)

    __rmul__ = __mul__

    def __truediv__(self, other):
        other = self._coerce_rat(other)
        ctx = current_ctx()
        (n1, d1), c1 = self._ids, self._cipher
        (n2, d2), c2 = other._ids, other._cipher
        num, _ = self._mul_nodes(ctx, n1, c1, d2, c2)
        den, _ = self._mul_nodes(ctx, d1, c1, n2, c2)
        return Rational._from_ids((num, den), cipher=True)

    def __rtruediv__(self, other):
        return self._coerce_rat(other).__truediv__(self)

    def __neg__(self):
        ctx = current_ctx()
        num = ctx.emit(Op.NEGATE, (self._ids[0],))
        return Rational._from_ids((num, self._ids[1]), cipher=True)


@lru_cache(maxsize=16)
def _encoder(ctx) -> BatchEncoder:
    return BatchEncoder(ctx)


class Batched(BfvType):
    """N SIMD integer slots in a 2 x (N/2) matrix (reference:
    `Batched<LANES>`, `batched.rs:68`). `<<`/`>>` rotate rows,
    `swap_rows()` swaps them (FHE IR ShiftLeft/ShiftRight/SwapRows)."""

    def __init__(self, values=None):
        super().__init__()
        self.value = None if values is None else np.asarray(values)

    @classmethod
    def encode(cls, value, params, device=None):
        """Slot values -> plaintext, through the port's BatchEncoder on
        `device` (None means CUDA)."""
        if isinstance(value, Batched):
            value = value.value
        enc = _encoder(get_context(params, device))
        v = np.asarray(value)
        full = np.zeros(params.poly_degree, dtype=np.int64)
        full[:v.size] = v.reshape(-1)
        return enc.encode_signed(full).cpu().numpy().astype(np.uint64)

    @classmethod
    def decode(cls, poly, params, device=None):
        enc = _encoder(get_context(params, device))
        poly = torch.as_tensor(np.asarray(poly).astype(np.int64))
        return enc.decode_signed(poly).cpu().numpy()

    def __lshift__(self, steps: int):
        ctx = current_ctx()
        out = ctx.emit(Op.SHIFT_LEFT, (self._ids[0],), int(steps))
        return Batched._from_ids((out,), cipher=True)

    def __rshift__(self, steps: int):
        ctx = current_ctx()
        out = ctx.emit(Op.SHIFT_RIGHT, (self._ids[0],), int(steps))
        return Batched._from_ids((out,), cipher=True)

    def swap_rows(self):
        ctx = current_ctx()
        out = ctx.emit(Op.SWAP_ROWS, (self._ids[0],))
        return Batched._from_ids((out,), cipher=True)


TYPE_REGISTRY = {
    "Signed": Signed,
    "Unsigned64": Unsigned64,
    "Rational": Rational,
    "Batched": Batched,
    "Unsigned": Unsigned,
}


def resolve_type(name: str):
    if name.startswith("Cipher<") and name.endswith(">"):
        name = name[len("Cipher<"):-1]
    if name.startswith("Fractional"):
        return Fractional[int(name[len("Fractional"):])] \
            if name != "Fractional" else Fractional
    if name.startswith("Unsigned<") and name.endswith(">"):
        return Unsigned[int(name[len("Unsigned<"):-1])]
    return TYPE_REGISTRY[name]

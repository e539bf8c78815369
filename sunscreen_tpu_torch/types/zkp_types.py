"""ZKP DSL: `@zkp_program`, `Field` program nodes, constraints, gadgets.

Replaces `sunscreen/src/types/zkp/` (`field.rs`, `program_node.rs`,
`gadgets/{binary,arithmetic}.rs`) and the `#[zkp_program]` macro
(`sunscreen_compiler_macros/src/zkp_program.rs`) with its
`#[private]`/`#[public]`/`#[constant]` argument attributes — here
expressed as `Private[Field]`, `Public[Field]`, `Constant[Field]`
annotations (bare `Field` means private, like the reference default).

Port of `sunscreen_tpu/types/zkp_types.py`, with the linked BFV plaintext
node classes (`Linked`, `BfvSigned`, ...), which only build circuits.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable

from sunscreen_tpu_torch.zk.backend import (Gadget, ZkpOp, ZkpProgram,
                                            ZkpProgramContext)

_TLS = threading.local()


def _ctx() -> ZkpProgramContext:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError("ZKP DSL types can only be used while a "
                           "#[zkp_program] is being traced")
    return ctx


class Field:
    """A native field element program node (reference:
    `types/zkp/field.rs`)."""

    def __init__(self, node: int):
        self.node = node

    # -- annotation plumbing -------------------------------------------------

    @staticmethod
    def _kind() -> str:
        return "private"

    # -- literals ------------------------------------------------------------

    @staticmethod
    def _lift(x) -> "Field":
        if isinstance(x, Field):
            return x
        return Field(_ctx().emit(ZkpOp.CONSTANT, (), int(x)))

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, other):
        other = Field._lift(other)
        return Field(_ctx().emit(ZkpOp.ADD, (self.node, other.node)))

    __radd__ = __add__

    def __sub__(self, other):
        other = Field._lift(other)
        return Field(_ctx().emit(ZkpOp.SUB, (self.node, other.node)))

    def __rsub__(self, other):
        return Field._lift(other).__sub__(self)

    def __mul__(self, other):
        other = Field._lift(other)
        return Field(_ctx().emit(ZkpOp.MUL, (self.node, other.node)))

    __rmul__ = __mul__

    def __neg__(self):
        return Field(_ctx().emit(ZkpOp.NEG, (self.node,)))

    def __pow__(self, e: int):
        if e < 1:
            raise ValueError("Field ** e needs e >= 1")
        result = None
        base = self
        while e:
            if e & 1:
                result = base if result is None else result * base
            e >>= 1
            if e:
                base = base * base
        return result

    # -- constraints ---------------------------------------------------------

    def constrain_eq(self, other):
        """Reference: `constrain_eq` constraint op."""
        other = Field._lift(other)
        diff = self - other
        _ctx().emit(ZkpOp.CONSTRAINT, (diff.node,), 0)
        return self

    def constrain_zero(self):
        _ctx().emit(ZkpOp.CONSTRAINT, (self.node,), 0)
        return self

    # -- gadget conveniences -------------------------------------------------

    def to_unsigned(self, bits: int) -> list["Field"]:
        """Binary decomposition via the ToUInt gadget; returns bit nodes
        (LSB first)."""
        outs = _ctx().invoke_gadget(ToUInt(bits), [self.node])
        return [Field(o) for o in outs]

    def inverse(self) -> "Field":
        (o,) = _ctx().invoke_gadget(Inverse(), [self.node])
        return Field(o)


class _KindAnnotation:
    def __init__(self, kind: str):
        self.kind = kind

    def __getitem__(self, item):
        """`Private[Field]` scalar, or `Private[Field, (64, 8)]` /
        `Private[Field, 5]` array args (reference:
        `[[Field<F>; 8]; 64]` program arguments, e.g.
        `sunscreen/benches/fractional_range_proof.rs:88`)."""
        if item is Field:
            return _FieldAnnotation(self.kind)
        inner, shape = item
        if inner is not Field:
            raise TypeError("shaped arguments hold Field elements")
        if isinstance(shape, int):
            shape = (shape,)
        return _FieldAnnotation(self.kind, tuple(int(s) for s in shape))


class _FieldAnnotation:
    def __init__(self, kind: str, shape: tuple[int, ...] | None = None):
        self.kind = kind
        self.shape = shape

    @property
    def count(self) -> int:
        if self.shape is None:
            return 1
        n = 1
        for s in self.shape:
            n *= s
        return n


Private = _KindAnnotation("private")
Public = _KindAnnotation("public")
Constant = _KindAnnotation("constant")


def _nest(flat: list, shape: tuple[int, ...]):
    """Flat node list -> nested python lists of the given shape."""
    if len(shape) == 1:
        return list(flat)
    sub = len(flat) // shape[0]
    return [_nest(flat[i * sub:(i + 1) * sub], shape[1:])
            for i in range(shape[0])]


# --------------------------------------------------------------------------
# gadgets (reference: types/zkp/gadgets/)
# --------------------------------------------------------------------------

class ToUInt(Gadget):
    """Binary decomposition: N hidden bits b_i with b_i^2 = b_i and
    sum b_i 2^i = x (reference: `gadgets/binary.rs:8-45`)."""

    def __init__(self, bits: int):
        self.bits = bits
        self.gadget_input_count = 1
        self.hidden_input_count = bits

    def compute_hidden_inputs(self, inputs, f):
        x = inputs[0] % f
        if x >= (1 << self.bits):
            raise ValueError(
                f"value {x} does not fit in {self.bits} bits")
        return [(x >> i) & 1 for i in range(self.bits)]

    def gen_circuit(self, ctx, gadget_inputs, hidden_inputs):
        (x,) = gadget_inputs
        acc = None
        for i, b in enumerate(hidden_inputs):
            # b * (b - 1) == 0
            one = ctx.emit(ZkpOp.CONSTANT, (), 1)
            bm1 = ctx.emit(ZkpOp.SUB, (b, one))
            prod = ctx.emit(ZkpOp.MUL, (b, bm1))
            ctx.emit(ZkpOp.CONSTRAINT, (prod,), 0)
            coeff = ctx.emit(ZkpOp.CONSTANT, (), 1 << i)
            term = ctx.emit(ZkpOp.MUL, (b, coeff))
            acc = term if acc is None else ctx.emit(ZkpOp.ADD, (acc, term))
        diff = ctx.emit(ZkpOp.SUB, (acc, x))
        ctx.emit(ZkpOp.CONSTRAINT, (diff,), 0)
        return list(hidden_inputs)


class Inverse(Gadget):
    """Hidden inverse: x * inv == 1 (reference:
    `gadgets/arithmetic.rs:132-161`)."""

    gadget_input_count = 1
    hidden_input_count = 1

    def compute_hidden_inputs(self, inputs, f):
        x = inputs[0] % f
        if x == 0:
            raise ZeroDivisionError("inverse of zero in zkp program")
        return [pow(x, -1, f)]

    def gen_circuit(self, ctx, gadget_inputs, hidden_inputs):
        (x,) = gadget_inputs
        (inv,) = hidden_inputs
        prod = ctx.emit(ZkpOp.MUL, (x, inv))
        ctx.emit(ZkpOp.CONSTRAINT, (prod,), 1)
        return [inv]


class SignedModulus(Gadget):
    """Field division with remainder: given x (as unsigned field value)
    and modulus m, hidden (q, r) with x = q*m + r, 0 <= r < m
    (reference: `gadgets/arithmetic.rs:10-42`). `max_bits` bounds q and
    r for the range checks."""

    def __init__(self, modulus: int, max_bits: int):
        self.modulus = modulus
        self.max_bits = max_bits
        self.gadget_input_count = 1
        self.hidden_input_count = 2

    def compute_hidden_inputs(self, inputs, f):
        x = inputs[0] % f
        return [x // self.modulus, x % self.modulus]

    def gen_circuit(self, ctx, gadget_inputs, hidden_inputs):
        (x,) = gadget_inputs
        q, r = hidden_inputs
        m = ctx.emit(ZkpOp.CONSTANT, (), self.modulus)
        qm = ctx.emit(ZkpOp.MUL, (q, m))
        total = ctx.emit(ZkpOp.ADD, (qm, r))
        diff = ctx.emit(ZkpOp.SUB, (total, x))
        ctx.emit(ZkpOp.CONSTRAINT, (diff,), 0)
        # range checks: q < 2^max_bits, r < m via r in [0, 2^ceil) and
        # m - 1 - r in range
        ctx.invoke_gadget(ToUInt(self.max_bits), [q])
        rbits = max(1, (self.modulus - 1).bit_length())
        ctx.invoke_gadget(ToUInt(rbits), [r])
        mm1 = ctx.emit(ZkpOp.CONSTANT, (), self.modulus - 1)
        gap = ctx.emit(ZkpOp.SUB, (mm1, r))
        ctx.invoke_gadget(ToUInt(rbits), [gap])
        return [q, r]


# --------------------------------------------------------------------------
# linked BFV plaintext types (reference:
# sunscreen/src/types/zkp/bfv_plaintext.rs — BfvSigned / BfvUnsigned64 /
# BfvUnsigned128 / BfvRational — and the #[linked] argument surface,
# sunscreen_compiler_macros/src/zkp_program.rs:110-164)
# --------------------------------------------------------------------------

class Linked:
    """`Linked[BfvSigned]` argument annotation: the argument's field
    inputs are the SDLP's shared witness bits for a linked BFV
    plaintext; the node recombines them IN-CIRCUIT."""

    def __class_getitem__(cls, inner):
        if inner not in (BfvSigned, BfvUnsigned64, BfvUnsigned128,
                         BfvRational):
            raise TypeError(f"Linked[{inner!r}]: not a linked BFV type")
        return _LinkedAnnotation(inner)


class _LinkedAnnotation:
    def __init__(self, inner):
        self.inner = inner


def _bits_per_coeff(plain_modulus: int) -> int:
    """Bits in the SDLP expansion of one centered message coefficient:
    the magnitude bound (t-1).bit_length() plus the sign bump
    (`VerifierKnowledge.b()`; reference `builder.rs:948` uses
    ceil_log2(t) magnitude bits the same way)."""
    return max(1, (plain_modulus - 1).bit_length()) + 1


class _BfvPlaintextNode:
    """Program node over one linked plaintext polynomial: a
    [degree_bound][bits_per_coeff] grid of bit nodes (LSB first,
    trailing sign bit), matching `twos_complement_bits` of the CENTERED
    coefficients. Because the SDLP stores message coefficients centered
    (bfv_statement.py), the in-circuit recombination is plain
    2's-complement — linear, no SignedModulus gadget (delta from
    `bfv_plaintext.rs:64-108`, which re-centers in-circuit; documented
    behavioral parity)."""

    def __init__(self, bit_grid: list[list[Field]], fresh_bound: int):
        self.bit_grid = bit_grid
        self.fresh_bound = fresh_bound

    def _coefficients(self) -> list[Field]:
        """Centered coefficient nodes c_j = sum b_i 2^i - sign 2^(B-1)
        (reference: `extract_coefficients`, bfv_plaintext.rs:64-108)."""
        out = []
        for bits in self.bit_grid:
            b = len(bits)
            acc = None
            for i, bit in enumerate(bits):
                w = (1 << i) if i < b - 1 else -(1 << (b - 1))
                term = bit * w
                acc = term if acc is None else acc + term
            out.append(acc)
        return out

    def into_field_elem(self) -> Field:
        """Decode per the Signed encoding: sum_j c_j * 2^j (reference:
        `AsFieldElement::into_field_elem`, bfv_plaintext.rs:110-128)."""
        acc = None
        for j, c in enumerate(self._coefficients()):
            term = c * (1 << j)
            acc = term if acc is None else acc + term
        return acc

    def constrain_fresh_encoding(self) -> None:
        """Coefficients within the fresh degree bound are ternary,
        beyond it zero (reference: `ConstrainFresh`,
        bfv_plaintext.rs:131-155)."""
        for j, c in enumerate(self._coefficients()):
            if j < self.fresh_bound:
                (c * (c - 1) * (c + 1)).constrain_zero()
            else:
                c.constrain_zero()


class _BfvRationalNode:
    """Numerator/denominator pair of linked signed plaintexts
    (reference: `BfvRational`, bfv_plaintext.rs:185-189)."""

    def __init__(self, num: _BfvPlaintextNode, den: _BfvPlaintextNode):
        self.num = num
        self.den = den

    def into_field_elems(self) -> tuple[Field, Field]:
        return self.num.into_field_elem(), self.den.into_field_elem()

    def constrain_fresh_encoding(self) -> None:
        self.num.constrain_fresh_encoding()
        self.den.constrain_fresh_encoding()


class _LinkedTypeMeta:
    """DEGREE_BOUND: linked polynomial degree (coefficients beyond it
    are constrained to 0 in the SDLP); FRESH_BOUND: ternary-digit
    degree bound for a freshly encoded value (reference `M`)."""

    DEGREE_BOUND = 128
    FRESH_BOUND = 64
    N_POLYS = 1

    @classmethod
    def num_native_field_elements(cls, plain_modulus: int,
                                  poly_degree: int) -> int:
        d = min(cls.DEGREE_BOUND, poly_degree)
        return cls.N_POLYS * d * _bits_per_coeff(plain_modulus)

    @classmethod
    def make_node(cls, fields: list[Field], plain_modulus: int,
                  poly_degree: int):
        b = _bits_per_coeff(plain_modulus)
        d = min(cls.DEGREE_BOUND, poly_degree)
        fresh = min(cls.FRESH_BOUND, d)
        polys = []
        per = d * b
        for p in range(cls.N_POLYS):
            grid = _nest(fields[p * per:(p + 1) * per], (d, b))
            polys.append(_BfvPlaintextNode(grid, fresh))
        if cls.N_POLYS == 1:
            return polys[0]
        return _BfvRationalNode(*polys)


class BfvSigned(_LinkedTypeMeta):
    """Linked `Signed` (reference: `BfvSigned<F>` +
    `LinkWithZkp for Signed`, `signed.rs:51` DEGREE_BOUND=128)."""

    DEGREE_BOUND = 128
    FRESH_BOUND = 64


class BfvUnsigned64(_LinkedTypeMeta):
    """Linked `Unsigned64` (reference: `unsigned.rs:355`)."""

    DEGREE_BOUND = 128
    FRESH_BOUND = 64


class BfvUnsigned128(_LinkedTypeMeta):
    """Linked `Unsigned128` (reference: `unsigned.rs:360`)."""

    DEGREE_BOUND = 255
    FRESH_BOUND = 128


class BfvRational(_LinkedTypeMeta):
    """Linked `Rational`: two signed polynomials (num, den)
    (reference: `rational.rs:34`)."""

    DEGREE_BOUND = 128
    FRESH_BOUND = 64
    N_POLYS = 2


# --------------------------------------------------------------------------
# @zkp_program
# --------------------------------------------------------------------------

class ZkpProgramFn:
    def __init__(self, fn: Callable, backend: str = "bulletproofs"):
        self.fn = fn
        self.name = fn.__name__
        self.backend_name = backend
        sig = inspect.signature(fn)
        self.args: list = []        # _FieldAnnotation | _LinkedAnnotation
        self.linked_types: list = []
        for p in sig.parameters.values():
            ann = p.annotation
            if ann is Field or ann is inspect.Parameter.empty:
                ann = _FieldAnnotation("private")
            if isinstance(ann, _LinkedAnnotation):
                if any(isinstance(a, _FieldAnnotation) for a in self.args):
                    raise TypeError(
                        f"linked arg {p.name!r} must precede all other "
                        "args (reference: zkp_program.rs:110-164)")
                self.args.append(ann)
                self.linked_types.append(ann.inner)
            elif isinstance(ann, _FieldAnnotation):
                self.args.append(ann)
            else:
                raise TypeError(
                    f"zkp_program arg {p.name!r}: annotate with Field / "
                    "Private[Field] / Public[Field] / Constant[Field] / "
                    "Private[Field, shape] / Linked[BfvSigned...]")
        self._cache: dict = {}

    def num_linked_inputs(self, params) -> int:
        """Total private inputs consumed by the linked-arg prefix."""
        return sum(t.num_native_field_elements(params.plain_modulus,
                                               params.poly_degree)
                   for t in self.linked_types)

    def build(self, params=None) -> ZkpProgram:
        """Trace to a ZkpProgram. Programs with `Linked[...]` args are
        parameter-dependent (input width scales with log2 t and N) and
        require `params` (reference: the Compiler passes the FHE params
        through, `sunscreen/src/compiler.rs:360-457`)."""
        if self.linked_types and params is None:
            raise TypeError(
                f"zkp_program {self.name!r} has linked args; build/prove "
                "it through a runtime or pass params=")
        cache_key = (None if params is None
                     else (params.plain_modulus, params.poly_degree))
        if cache_key in self._cache:
            return self._cache[cache_key]
        ctx = ZkpProgramContext()
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = ctx
        try:
            counters = {"private": 0, "public": 0, "constant": 0}
            op_of = {"private": ZkpOp.PRIVATE_INPUT,
                     "public": ZkpOp.PUBLIC_INPUT,
                     "constant": ZkpOp.CONSTANT_INPUT}

            def fresh(kind):
                idx = counters[kind]
                counters[kind] += 1
                return Field(ctx.emit(op_of[kind], (), idx))

            args = []
            for ann in self.args:
                if isinstance(ann, _LinkedAnnotation):
                    count = ann.inner.num_native_field_elements(
                        params.plain_modulus, params.poly_degree)
                    fields = [fresh("private") for _ in range(count)]
                    args.append(ann.inner.make_node(
                        fields, params.plain_modulus,
                        params.poly_degree))
                elif ann.shape is None:
                    args.append(fresh(ann.kind))
                else:
                    flat = [fresh(ann.kind) for _ in range(ann.count)]
                    args.append(_nest(flat, ann.shape))
            self.fn(*args)
        finally:
            _TLS.ctx = prev
        self._cache[cache_key] = ctx.prog
        return ctx.prog


def zkp_program(backend: str = "bulletproofs"):
    """Decorator — reference parity: `#[zkp_program]`."""
    def wrap(fn):
        return ZkpProgramFn(fn, backend)
    return wrap


def constrain_eq(a: Field, b) -> None:
    a.constrain_eq(b)

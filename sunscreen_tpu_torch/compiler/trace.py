"""Tracing frontend: the `@fhe_program` decorator and the thread-local
graph context (port of `sunscreen_tpu/compiler/trace.py`).

The decorator inspects the type annotations and runs the function over
handle objects whose operators append IR nodes. The literal pool stays
numpy `uint64`, as in the reference; the trace also carries the device
that encodes a `Batched` literal (`types/bfv_types.py`).
"""

from __future__ import annotations

import inspect
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from sunscreen_tpu_torch.compiler.ir import FheProgram, Op

_TLS = threading.local()


class TraceContext:
    """Graph under construction, encoding params, the device that
    encodes batched literals, and the literal pool."""

    def __init__(self, params, device=None):
        self.prog = FheProgram()
        self.params = params
        self.device = device
        self.literals: list[np.ndarray] = []

    def emit(self, op: Op, operands: tuple[int, ...] = (),
             data: int | None = None) -> int:
        return self.prog.add(op, operands, data)

    def literal_plaintext(self, poly: np.ndarray) -> int:
        """Intern an encoded literal; returns a LITERAL node id."""
        for i, p in enumerate(self.literals):
            if np.array_equal(p, poly):
                return self.emit(Op.LITERAL, (), i)
        self.literals.append(np.asarray(poly, dtype=np.uint64))
        return self.emit(Op.LITERAL, (), len(self.literals) - 1)


def current_ctx() -> TraceContext:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "not inside an #[fhe_program] trace — FHE DSL types can only "
            "be operated on while a program is being compiled")
    return ctx


@dataclass
class CallSignature:
    """Runtime-checkable program signature (reference:
    `sunscreen_runtime/src/metadata.rs:20-229` `CallSignature`)."""

    arg_types: list[tuple[str, bool]]   # (type name, is_cipher)
    ret_types: list[tuple[str, bool]]
    num_ciphertexts: list[int]          # per return value


class FheProgramFn:
    """The object `@fhe_program` produces (reference:
    `sunscreen/src/compiler.rs:26-136`, `FheProgramFn`)."""

    def __init__(self, fn: Callable, scheme: str, chain_count: int = 1):
        if scheme != "bfv":
            raise ValueError(f"unsupported scheme {scheme!r}")
        self.fn = fn
        self.scheme = scheme
        self.chain_count = chain_count
        self.name = fn.__name__
        hints = inspect.signature(fn)
        self.arg_annotations = []
        for p in hints.parameters.values():
            if p.annotation is inspect.Parameter.empty:
                raise TypeError(
                    f"fhe_program argument {p.name!r} needs a type "
                    "annotation (e.g. a: Cipher[Signed])")
            self.arg_annotations.append((p.name, p.annotation))

    def build(self, params, device=None) -> tuple[FheProgram, CallSignature,
                                                  list[np.ndarray]]:
        """Trace the Python function into an FheProgram; `device` encodes
        batched literals (None means CUDA)."""
        ctx = TraceContext(params, device)
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = ctx
        try:
            args = []
            arg_sig = []
            input_idx = 0
            for name, ann in self.arg_annotations:
                handle, used, is_cipher = ann._make_input(ctx, input_idx)
                input_idx += used
                args.append(handle)
                arg_sig.append((ann._type_name(), is_cipher))
            result = self.fn(*args)
            outs = result if isinstance(result, tuple) else (result,)
            ret_sig = []
            num_cts = []
            for out in outs:
                ids = out._output_ids()
                for i in ids:
                    ctx.prog.outputs.append(
                        ctx.emit(Op.OUTPUT_CIPHERTEXT, (i,)))
                ret_sig.append((type(out)._type_name(), True))
                num_cts.append(len(ids))
        finally:
            _TLS.ctx = prev
        sig = CallSignature(arg_sig, ret_sig, num_cts)
        return ctx.prog, sig, ctx.literals

    def compile(self, params=None, plain_modulus=None, security_level=None,
                noise_margin=None, measured=False, device=None):
        """One-program compile; the arguments map onto the Compiler
        builder (reference: `FheProgramFnExt`, `compiler.rs:90-136`)."""
        from sunscreen_tpu_torch.compiler.compiler import Compiler
        c = Compiler(device).fhe_program(self)
        if params is not None:
            c = c.with_params(params)
        if plain_modulus is not None:
            c = c.plain_modulus(plain_modulus)
        if security_level is not None:
            c = c.security_level(security_level)
        if noise_margin is not None:
            c = c.additional_noise_budget(noise_margin)
        if measured:
            c = c.use_measured_noise_model()
        return c.compile()


def fhe_program(scheme: str = "bfv", chain_count: int = 1):
    """Decorator (reference: `#[fhe_program(scheme = "bfv")]`,
    `sunscreen_compiler_macros/src/fhe_program.rs:10-20`)."""
    def wrap(fn):
        return FheProgramFn(fn, scheme, chain_count)
    return wrap

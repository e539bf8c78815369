"""Compiler builder: trace -> passes -> parameter search -> Application
(port of `sunscreen_tpu/compiler/compiler.py`).

Two departures from the reference. `engine("auto")` picks the u32 engine
on CUDA, whose kernels hold it, and follows the reference elsewhere (u64
off the TPU: `compiler.py:136-139`). The search skips a degree whose
context raises the port's `Unsupported` (the "pallas" plans stop at
N = 16384, `math/ntt.py`), in the measured run too, where the reference
asserts. The builder's ZKP half (`zkp_program`, `zkp_backend`,
`Application.get_zkp_program`) is the reference's: a ZKP-only application
needs no FHE params.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.bfv.params import (MAX_LOG_Q, BfvParams,
                                            batching_plain_modulus,
                                            default_moduli,
                                            default_moduli_u32)
from sunscreen_tpu_torch.compiler import noise as noise_model
from sunscreen_tpu_torch.compiler.ir import FheProgram, Op
from sunscreen_tpu_torch.compiler.passes import compile_program
from sunscreen_tpu_torch.compiler.trace import CallSignature, FheProgramFn
from sunscreen_tpu_torch.errors import ParamsError, Unsupported
from sunscreen_tpu_torch.types.zkp_types import ZkpProgramFn
from sunscreen_tpu_torch.zk.backend import BulletproofsBackend

DEFAULT_NOISE_MARGIN_BITS = 20  # reference: compiler.rs:148-159

# a candidate degree the search moves past (the reference's three, and the
# port's named raise where the reference asserts)
_SKIP = (AssertionError, ValueError, ParamsError, Unsupported)


class PlainModulusConstraint:
    """Reference: `sunscreen/src/params.rs:19-35`."""

    def __init__(self, raw: int | None = None,
                 batching_min_bits: int | None = None):
        assert (raw is None) != (batching_min_bits is None)
        self.raw = raw
        self.batching_min_bits = batching_min_bits

    @staticmethod
    def Raw(v: int) -> "PlainModulusConstraint":
        return PlainModulusConstraint(raw=v)

    @staticmethod
    def BatchingMinimum(bits: int) -> "PlainModulusConstraint":
        return PlainModulusConstraint(batching_min_bits=bits)

    def modulus_for(self, poly_degree: int) -> int:
        if self.raw is not None:
            return self.raw
        return batching_plain_modulus(poly_degree, self.batching_min_bits)


@dataclass
class CompiledFheProgram:
    """IR, signature and literal plaintext pool of one program, with its
    params (reference: `sunscreen_runtime/src/metadata.rs`)."""

    name: str
    prog: FheProgram
    signature: CallSignature
    literals: list[np.ndarray]
    params: BfvParams

    @property
    def requires_relin_keys(self) -> bool:
        return self.prog.requires_relin_keys

    @property
    def requires_galois_keys(self) -> bool:
        return self.prog.requires_galois_keys

    @property
    def nodes(self):
        return self.prog.nodes


@dataclass
class Application:
    """name -> program map sharing one parameter set (reference:
    `Application<T>`, `sunscreen/src/lib.rs:83-218`), with the ZKP
    programs when the builder compiles some."""

    params: BfvParams | None
    programs: dict[str, CompiledFheProgram] = field(default_factory=dict)
    zkp_programs: dict[str, object] = field(default_factory=dict)

    def get_program(self, name_or_fn) -> CompiledFheProgram:
        name = getattr(name_or_fn, "name", name_or_fn)
        return self.programs[name]

    def get_zkp_program(self, name_or_fn):
        """Reference: `Application::get_zkp_program` (`lib.rs:200-218`)."""
        name = getattr(name_or_fn, "name", name_or_fn)
        return self.zkp_programs[name]


class Compiler:
    """Builder: `Compiler().fhe_program(f).compile()` (reference:
    `compiler.rs:360-457`). `device` (None means CUDA) is where the
    measured search runs and batched literals are encoded, and picks the
    engine under "auto"; it is resolved only when one of those needs
    it."""

    SEARCH_DEGREES = (1024, 2048, 4096, 8192, 16384, 32768)

    def __init__(self, device=None):
        self._device = device
        self._programs: list[FheProgramFn] = []
        self._zkp_programs: list = []
        self._zkp_backend = None
        self._params: BfvParams | None = None
        self._plain_constraint = PlainModulusConstraint.BatchingMinimum(20)
        self._security = 128
        self._noise_margin = DEFAULT_NOISE_MARGIN_BITS
        # the search confirms the analytically chosen N with the
        # measured model, as the reference does; the reference's
        # SUNSCREEN_TPU_MEASURED_SEARCH=0 (or use_measured_noise_model
        # (False)) searches with the analytic model alone
        self._measured_model = os.environ.get(
            "SUNSCREEN_TPU_MEASURED_SEARCH", "1") != "0"
        self._engine = "auto"

    def engine(self, which: str) -> "Compiler":
        """Word engine of the searched modulus chain: 'u32' (every
        modulus < 2^30: the CUDA kernels), 'u64' (fewer, larger limbs:
        plain PyTorch), or 'auto' (u32 on CUDA, else u64). `with_params`
        overrides it."""
        if which not in ("u32", "u64", "auto"):
            raise ValueError("engine must be 'u32', 'u64' or 'auto'")
        self._engine = which
        return self

    def _moduli_for(self, n: int):
        eng = self._engine
        if eng == "auto":
            eng = ("u32" if resolve_device(self._device).type == "cuda"
                   else "u64")
        return (default_moduli_u32(n, self._security) if eng == "u32"
                else default_moduli(n, self._security))

    def use_measured_noise_model(self, enabled: bool = True) -> "Compiler":
        """Confirm the searched parameters by encrypting and running
        each program at the surviving N (`MeasuredModel`)."""
        self._measured_model = enabled
        return self

    def fhe_program(self, prog: FheProgramFn) -> "Compiler":
        if not isinstance(prog, FheProgramFn):
            raise TypeError("expected an @fhe_program-decorated function")
        if any(p.name == prog.name for p in self._programs):
            raise ValueError(f"duplicate program name {prog.name!r}")
        self._programs.append(prog)
        return self

    def zkp_program(self, prog) -> "Compiler":
        """Add a `@zkp_program` function (reference:
        `Compiler::zkp_program`, `sunscreen/src/compiler.rs:360-457`)."""
        if not isinstance(prog, ZkpProgramFn):
            raise TypeError("expected a @zkp_program-decorated function")
        if any(p.name == prog.name for p in self._zkp_programs):
            raise ValueError(f"duplicate zkp program name {prog.name!r}")
        self._zkp_programs.append(prog)
        return self

    def zkp_backend(self, backend=None) -> "Compiler":
        """The proof backend (reference: `Compiler::zkp_backend::<B>()`,
        `compiler.rs:304`); Bulletproofs by default."""
        self._zkp_backend = backend or BulletproofsBackend()
        return self

    def with_params(self, params: BfvParams) -> "Compiler":
        self._params = params
        return self

    def plain_modulus_constraint(
            self, c: PlainModulusConstraint) -> "Compiler":
        self._plain_constraint = c
        return self

    def plain_modulus(self, v: int) -> "Compiler":
        return self.plain_modulus_constraint(PlainModulusConstraint.Raw(v))

    def security_level(self, bits: int) -> "Compiler":
        self._security = bits
        return self

    def additional_noise_budget(self, bits: int) -> "Compiler":
        self._noise_margin = bits
        return self

    # -- param search (reference: determine_params, params.rs:119-236) ------

    def _measured_budget(self, compiled, chain_count: int) -> float:
        """The worst output budget over chain_count runs, each run's
        inputs at the previous run's worst budget (reference:
        params.rs:199-226, measured_model.rs:57-130)."""
        target = None
        measured = float("inf")
        n_ct = sum(1 for nd in compiled.nodes
                   if nd.op == Op.INPUT_CIPHERTEXT)
        for _ in range(max(1, chain_count)):
            measured = noise_model.MeasuredModel(
                compiled, compiled.params, input_targets=target,
                device=self._device).worst_budget
            if measured < self._noise_margin:
                break
            target = [noise_model.TargetNoiseLevel(measured)] * n_ct
        return measured

    def _search_params(self) -> BfvParams:
        last_err: Exception | None = None
        for n in self.SEARCH_DEGREES:
            if n not in MAX_LOG_Q[self._security]:
                continue
            try:
                t = self._plain_constraint.modulus_for(n)
                qs, sp = self._moduli_for(n)
                params = BfvParams(n, t, qs, sp, self._security)
            except _SKIP as e:
                # no valid candidate at this degree (e.g. the u32
                # engine's small-N limbs below a batching t) -> next N
                last_err = e
                continue
            ok = True
            for pf in self._programs:
                try:
                    prog, sig, lits = pf.build(params, self._device)
                    prog = compile_program(prog)
                except Exception as e:  # e.g. literal overflow at small N
                    last_err = e
                    ok = False
                    break
                budget = self._chained_budget(prog, params, pf.chain_count)
                if budget < self._noise_margin:
                    ok = False
                    break
                if self._measured_model:
                    compiled = CompiledFheProgram(pf.name, prog, sig,
                                                  lits, params)
                    try:
                        measured = self._measured_budget(compiled,
                                                         pf.chain_count)
                    except _SKIP as e:
                        last_err = e
                        ok = False
                        break
                    if measured < self._noise_margin:
                        ok = False
                        break
            if ok:
                return params
        raise RuntimeError(
            f"no parameter set satisfies the programs (last error: "
            f"{last_err})")

    @staticmethod
    def _chained_budget(prog, params, chain_count: int) -> float:
        v = None
        for _ in range(max(1, chain_count)):
            bits = noise_model.predict_noise(prog, params, input_noise=v)
            v = 2.0 ** bits
        return -(np.log2(v) + 1.0)

    # -- compile -------------------------------------------------------------

    def compile(self) -> Application:
        if not self._programs and not self._zkp_programs:
            raise ValueError("no programs to compile")
        if (len(self._programs) > 1
                and any(pf.chain_count != 1 for pf in self._programs)):
            raise Unsupported(
                "chain_count > 1 requires compiling exactly one program "
                "(reference: compiler.rs chaining restriction)")
        params = None
        if self._programs:
            params = self._params or self._search_params()
        app = Application(params)
        for pf in self._programs:
            prog, sig, literals = pf.build(params, self._device)
            prog = compile_program(prog)
            app.programs[pf.name] = CompiledFheProgram(
                pf.name, prog, sig, literals, params)
        for zf in self._zkp_programs:
            # tracing checks the circuit (reference: compile_zkp,
            # compiler.rs:464-505); the runtime proves from the traced graph
            zf.build()
            app.zkp_programs[zf.name] = zf
        return app

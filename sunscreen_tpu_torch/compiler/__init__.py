"""FHE compiler stack: tracing DSL -> IR -> passes -> lowered programs
over the port's BFV ops (port of `sunscreen_tpu.compiler`)."""

from sunscreen_tpu_torch.compiler.compiler import (  # noqa: F401
    Application, CompiledFheProgram, Compiler, PlainModulusConstraint)
from sunscreen_tpu_torch.compiler.ir import FheProgram, Op  # noqa: F401
from sunscreen_tpu_torch.compiler.trace import fhe_program  # noqa: F401

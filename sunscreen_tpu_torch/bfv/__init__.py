"""BFV on RNS polynomial rings, u32 engine (port of `sunscreen_tpu.bfv`).

Public surface: `BfvParams`, `BfvContext`/`get_context`, keygen in
`keys`, evaluator ops in `ops`, `BatchEncoder`.
"""

from sunscreen_tpu_torch.bfv.context import BfvContext, get_context  # noqa: F401
from sunscreen_tpu_torch.bfv.encoder import BatchEncoder  # noqa: F401
from sunscreen_tpu_torch.bfv.params import BfvParams  # noqa: F401

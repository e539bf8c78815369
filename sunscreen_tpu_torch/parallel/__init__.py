"""Multi-device parallelism on `torch.distributed`: the mesh primitives
(`mesh.py`), the distributed four-step NTT (`dntt.py`), coefficient-
sharded BFV (`sharded_bfv.py`), batch- and coefficient-sharded TFHE
(`sharded_tfhe.py`) and collective accounting (`ici_model.py`); port of
`sunscreen_tpu/parallel/`. `compiler.lower.lower_program_sharded` runs a
whole compiled program over a mesh."""

from sunscreen_tpu_torch.parallel.dntt import (  # noqa: F401
    DistributedNttPlan, make_distributed_negacyclic_mul)

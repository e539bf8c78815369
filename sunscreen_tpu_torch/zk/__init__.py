"""ZKP stack (port of `sunscreen_tpu.zk`): the ristretto255 group, merlin
transcripts, Bulletproofs R1CS, the ZKP backend IR, the host C++ kernels
(`native.py`) and the CUDA Pippenger MSM (`cuda_curve.py`). SDLP lives in
the reference's `sunscreen_tpu.logproof`, not ported yet."""

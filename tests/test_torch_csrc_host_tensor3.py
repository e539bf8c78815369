"""csrc/tensor3.cu (B4, B13) built with g++ against the host stand-in for
the CUDA runtime and held bit for bit against its plain twin at N = 256,
2048, 8192 and 16384 (the build and helpers of test_torch_csrc_host.py)."""

import numpy as np
import pytest
import torch

from test_torch_csrc_host import _plan, _ptr, _residues, host


@pytest.mark.parametrize("n", [256, 2048, 8192, 16384])
def test_tensor3_kernels_match_twins(host, n):
    """fwd_tensor3 without (B4) and with (B13) the inverse transforms on
    [2, 4, 2, N] operands (at N = 16384 a task takes 1024 threads and
    192 KB of shared memory), every operand of the first row at q - 1."""
    _, libs = host
    plan = _plan(n, 2)
    ext = _residues(np.random.default_rng(n + 1), plan, (2, 4))
    twp, consts = plan.twp.numpy(), plan.consts.numpy()
    out = np.empty((2, 3, 2, n), dtype=np.int64)
    e = torch.from_numpy(ext)
    for full, want in ((0, plan.fwd_tensor3_plain(e)),
                       (1, plan.fwd_tensor3_full_plain(e))):
        assert libs["tensor3"].fwd_tensor3(
            _ptr(ext), _ptr(out), _ptr(twp), _ptr(consts), 2, 2,
            n.bit_length() - 1, full, None) == 0
        np.testing.assert_array_equal(out, want.numpy())

"""csrc/inv_tensor3.cu (B12) built with g++ against the host stand-in for the
CUDA runtime and held bit for bit against its twin on strided operands (the
build and helpers of test_torch_csrc_host_pntt.py)."""

import numpy as np
import pytest
import torch

from test_torch_csrc_host import _plan
from test_torch_csrc_host_pntt import _p, host


@pytest.mark.parametrize("n,rows,k", [(256, 2, 3), (2048, 2, 3),
                                      (16384, 1, 2)])
def test_inv_tensor3_kernel_matches_twin(host, n, rows, k):
    """inv_tensor3 (B12) on a and b, the halves of one [rows, 4, k, N]
    stack read through their row strides, every operand of the first row
    at q - 1 (the largest products); at N = 256 several tasks share a
    block and some slots are spare, at N = 16384 a task takes 1024
    threads and 192 KB of shared memory."""
    _, libs = host
    plan = _plan(n, k)
    q = plan.q.numpy()
    ext = np.random.default_rng(n + 2).integers(0, 1 << 62,
                                                (rows, 4, k, n)) % q
    ext[0] = q - 1
    a, b = ext[:, :2], ext[:, 2:]
    out = np.empty((rows, 3, k, n), dtype=np.int64)
    stride = 4 * k * n
    assert libs["inv_tensor3"].inv_tensor3(
        _p(ext), _p(ext) + 2 * k * n * 8, _p(out), _p(plan.twp.numpy()),
        _p(plan.consts.numpy()), rows, k, n.bit_length() - 1, stride, stride,
        None) == 0
    want = plan.inv_tensor3_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out, want.numpy())

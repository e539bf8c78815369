"""The keyswitch megakernel's CUDA source (`csrc/ks_full.cu`, on
`csrc/transform.cuh`) compiled for the host with the stand-in CUDA runtime
of `tests/test_torch_csrc_host.py` and run against the plain PyTorch twins,
bit for bit: `ks_full` (B14, raw u32 digits under every limb) and
`ks_full_limbs` (B15, each limb's own digit residues) at N = 256, 1024,
8192 and 16384, in both block shapes (N <= 4096: two slots of transform
threads, each transforming every other digit, their sums added through
shared memory, the two components inverse-transformed side by side; N >=
8192: the digits one after another), at the TFHE step's 6 digits of 4
limbs, with odd digit counts (a spare slot in the last round), and at 16
and 20 digits with every digit at its largest value
(2^32 - 1 raw, q - 1 per limb) and every key word at q - 1, where the
component sums would pass 2^64 unless reduced. Needs a C++20 compiler
(g++)."""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch import _build
from test_torch_csrc_host import HOST_CUDA, _compile, _host_source, _plan


@pytest.fixture(scope="module")
def ks_full(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host_ks_full"))
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(HOST_CUDA)
    lib = ctypes.CDLL(_compile(out, "ks_full", _host_source("ks_full"),
                               True))
    for fn, sig in _build.SIGNATURES["ks_full"].items():
        getattr(lib, fn).argtypes = [_build._CTYPES[c] for c in sig]
    return lib.ks_full


def _p(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


# (rows, kdig, k, extreme) per N: below 8192 two slots, 5 digits leaving
# slot 1 spare in the last round, the TFHE step's 6 digits of 4 limbs and
# 20 digits; above, one transform's threads a block.
GRIDS = {256: ((2, 5, 3, False), (1, 20, 2, True)),
         1024: ((2, 6, 4, False), (1, 20, 2, True)),
         8192: ((1, 3, 2, False), (1, 16, 2, True)),
         16384: ((1, 2, 2, False), (1, 20, 2, True))}


def _case(rng, plan, rows, kdig, per_limb, extreme):
    """Digits and keys: at their largest values when `extreme`; else
    random, with the first row and digit of each at its largest value and
    coefficient 0 of every limb at q - 1 (raw words at 2^32 - 1)."""
    k, n = plan.k, plan.n
    q = plan.q.numpy()
    if extreme:
        k0 = np.ascontiguousarray(np.broadcast_to(q - 1, (kdig, k, n)))
        d = (np.ascontiguousarray(np.broadcast_to(q - 1, (rows, kdig, k, n)))
             if per_limb else np.full((rows, kdig, n), (1 << 32) - 1))
        return d, k0, k0.copy()
    k0 = rng.integers(0, 1 << 62, (kdig, k, n)) % q
    k1 = rng.integers(0, 1 << 62, (kdig, k, n)) % q
    k0[0] = q - 1
    k1[:, :, 0] = q[:, 0] - 1
    if per_limb:
        d = rng.integers(0, 1 << 62, (rows, kdig, k, n)) % q
        d[0, 0] = q - 1
        d[..., 0] = q[:, 0] - 1
    else:
        d = rng.integers(0, 1 << 32, (rows, kdig, n))
        d[0, 0] = (1 << 32) - 1
        d[..., 0] = (1 << 32) - 1
    return d, k0, k1


@pytest.mark.parametrize("per_limb", [0, 1])
@pytest.mark.parametrize("n", sorted(GRIDS))
def test_ks_full_kernel_matches_twin(ks_full, n, per_limb):
    """ks_full (B14, per_limb 0) and ks_full_limbs (B15, per_limb 1)
    against ks_full_plain and ks_full_limbs_plain, a 30-bit limb (lazy
    values up to 4q - 1) and small ones."""
    rng = np.random.default_rng(2 * n + per_limb)
    for rows, kdig, k, extreme in GRIDS[n]:
        plan = _plan(n, k)
        d, k0, k1 = _case(rng, plan, rows, kdig, per_limb, extreme)
        out = np.empty((rows, 2, k, n), dtype=np.int64)
        assert ks_full(_p(d), _p(k0), _p(k1), _p(out), _p(plan.twp.numpy()),
                       _p(plan.consts.numpy()), rows, kdig, k,
                       n.bit_length() - 1, per_limb, None) == 0
        plain = plan.ks_full_limbs_plain if per_limb else plan.ks_full_plain
        want = plain(*map(torch.from_numpy, (d, k0, k1)))
        np.testing.assert_array_equal(out, want.numpy())


def test_ks_full_refuses_unsupported_sizes(ks_full):
    """No kernel runs outside 256 <= N <= 16384: the C entry returns
    cudaErrorInvalidValue for either use."""
    x = np.zeros(1 << 15, dtype=np.int64)
    for logn in (7, 15):
        for per_limb in (0, 1):
            assert ks_full(_p(x), _p(x), _p(x), _p(x), _p(x), _p(x), 1, 1,
                           1, logn, per_limb, None) == 1

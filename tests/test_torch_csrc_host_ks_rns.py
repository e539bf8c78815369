"""The keyswitch and RNS kernels' CUDA sources (`csrc/inv_ks.cu`,
`csrc/rns.cu`) compiled for the host with the stand-in CUDA runtime of
`tests/test_torch_csrc_host.py` and run against the plain PyTorch twins,
bit for bit, at small sizes: inv_ks (B5) in both of its block shapes,
with up to 16 digits and residues at q - 1; scale_convert (B7) and the
other entry points of rns.cu at the bases of 7, 14, 17 and 29 limbs (15,
29, 35 and 59 limbs in the tensor base, the register bounds of each
kernel up to its largest, 64 limbs), with
columns whose normalized digits are all q_i - 1, so that every carry of
the fixed-point sums reaches the integer word, and columns next to the
rounding boundary; and common.cuh's 32-bit reductions against 128-bit
arithmetic. Needs a C++20 compiler (g++)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch import _build
from test_torch_csrc_host import HOST_CUDA, _compile, _host_source, _plan

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host_ks_rns"))
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(HOST_CUDA)
    libs = {}
    for name in ("inv_ks", "rns"):
        lib = ctypes.CDLL(_compile(out, name, _host_source(name), True))
        for fn, sig in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = [_build._CTYPES[c] for c in sig]
        libs[name] = lib
    return libs


def _p(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


# (rows, kdig, k) per N: both block shapes (N <= 4096: 2 N / 16 threads,
# the components side by side; above: N / 16, one after the other), 16
# digits, and N = 16384 at cell 3's 14 digits too.
INV_KS_GRIDS = {256: ((2, 16, 3), (3, 5, 2)), 1024: ((2, 16, 3),),
                8192: ((2, 16, 2),), 16384: ((1, 16, 2), (1, 14, 3))}


@pytest.mark.parametrize("n", sorted(INV_KS_GRIDS))
def test_inv_ks_kernel_matches_twin(host, n):
    """inv_ks (B5): the digit contraction against both key components and
    the two inverse transforms, digits and keys of the first row and
    digit at q - 1 (the largest u64 sums), a 30-bit limb."""
    rng = np.random.default_rng(n)
    for rows, kdig, k in INV_KS_GRIDS[n]:
        plan = _plan(n, k)
        q = plan.q.numpy()
        d = rng.integers(0, 1 << 62, (rows, kdig, k, n)) % q
        k0 = rng.integers(0, 1 << 62, (kdig, k, n)) % q
        k1 = rng.integers(0, 1 << 62, (kdig, k, n)) % q
        d[0] = q - 1
        d[..., 0] = q[:, 0] - 1
        k0[0] = q - 1
        k1[:, :, :2] = q - 1
        out = np.empty((rows, 2, k, n), dtype=np.int64)
        twp, consts = plan.twp.numpy(), plan.consts.numpy()
        assert host["inv_ks"].inv_ks(
            _p(d), _p(k0), _p(k1), _p(out), _p(twp), _p(consts), rows, kdig,
            k, n.bit_length() - 1, None) == 0
        want = plan.inv_ks_plain(*map(torch.from_numpy, (d, k0, k1)))
        np.testing.assert_array_equal(out, want.numpy())


def _convert_input(base, rng, n: int = 256):
    """[2, 3, k, N] residues of `base`: random, with column 0 at normalized
    digits y_i = q_i - 1 (the largest limb sums), column 1 at x = -1, and
    columns 2.. at x = 0, 1, 2 and next to Q / 2, where alpha's floor and
    its rounding turn."""
    x = np.stack([rng.integers(0, q, (2, 3, n)) for q in base.moduli],
                 axis=-2)
    for i, (q, p) in enumerate(zip(base.moduli, base.punctured)):
        x[..., i, 0] = (q - 1) * (p % q) % q
        x[..., i, 1] = q - 1
    half = base.product // 2
    for col, v in enumerate((0, 1, 2, half - 2, half - 1, half, half + 1,
                             half + 2), start=2):
        x[0, 0, :, col] = [v % q for q in base.moduli]
    return x


def _tensor_input(ctx, rng, rows: int = 2):
    """[rows, 3, ks, N] tensor-base residues: random, with column 0 of each
    row at normalized digits y_i = q_i - 1, column 1 at x = -1 (every
    x_i = q_i - 1), and columns 2.. at values v whose t v / Q lies next to
    a half-integer (where the rounding of r turns)."""
    mb, t, big_q = ctx.mul_base, ctx.t, ctx.q_base.product
    x = np.stack([rng.integers(0, q, (rows, 3, ctx.n)) for q in mb.moduli],
                 axis=-2)
    for i, (q, p) in enumerate(zip(mb.moduli, mb.punctured)):
        x[..., i, 0] = (q - 1) * (p % q) % q
        x[..., i, 1] = q - 1
    col = 2
    for h in (1, 3, 2 * t - 1):
        mid = h * big_q // (2 * t)
        for v in range(mid - 2, mid + 3):
            x[0, 0, :, col] = [v % q for q in mb.moduli]
            col += 1
    return x


def test_entry_points_refuse_unsupported_shapes(host):
    """inv_ks runs no kernel outside 256 <= N <= 16384; scale_convert and
    rns_scale none above 64 limbs in the tensor base nor above 32 in B,
    rns_convert none above 32 limbs a base: the C entry returns
    cudaErrorInvalidValue."""
    x = np.zeros(1 << 15, dtype=np.int64)
    for logn in (7, 15):
        assert host["inv_ks"].inv_ks(_p(x), _p(x), _p(x), _p(x), _p(x),
                                     _p(x), 1, 1, 1, logn, None) == 1
    for ks, km in ((65, 8), (16, 33)):
        assert host["rns"].scale_convert(
            _p(x), _p(x), _p(x), _p(x), _p(x), _p(x), _p(x), 1, ks, km, 7,
            256, None) == 1
    for ks, kd in ((65, 8), (40, 33)):
        assert host["rns"].rns_scale(_p(x), _p(x), _p(x), _p(x), _p(x), 1,
                                     ks, kd, 256, None) == 1
    for ks, kd in ((33, 8), (8, 33)):
        assert host["rns"].rns_convert(_p(x), _p(x), _p(x), _p(x), _p(x), 1,
                                       ks, kd, 256, 0, 0, None) == 1


REDUCTIONS = r"""
#include "cuda_runtime.h"
#include "common.cuh"
#include <cstdio>
#include <random>
typedef unsigned __int128 u128;
int main() {
  std::mt19937_64 g(7);
  int bad = 0;
  const u32 qs[] = {(1u << 17) + 1, 40961, 536870909, 1073741789,
                    (1u << 30) - 1, 1073479681};
  for (u32 q : qs) {
    const u64 m = (u64)(((u128)1 << 64) / q);
    const Red32 r = red32(q, m);
    const u32 edge[] = {0, 1, q - 1};
    for (int i = 0; i < 20000; ++i) {
      const u32 w = i < 3 ? edge[i] : (u32)(g() % q);
      if (shoup32(w, q, m) != (u32)(((u128)w << 32) / q)) ++bad;
      const u64 xs[] = {g(), ~0ull, (u64)(q - 1) * (q - 1) * 16,
                        (u64)w * (q - 1), (u64)w << 32, g() >> (i % 64)};
      for (u64 x : xs) {
        const u32 v = red2q(x, r);
        if (v >= 2 * q || v % q != x % q || red(x, r) != x % q) ++bad;
      }
    }
  }
  printf("%d mismatches\n", bad);
  return bad != 0;
}
"""


def test_reductions_match_exact_arithmetic(host):
    """common.cuh's 32-bit reductions against 128-bit integer arithmetic:
    shoup32 is floor(w 2^32 / q) for every w < q tried, red2q(x) lies in
    [0, 2q) and red(x) is x mod q for u64 words up to 2^64 - 1, at odd
    moduli from 2^17 + 1 to 2^30 - 1."""
    out = os.path.dirname(host["rns"]._name)
    exe = _compile(out, "reductions", REDUCTIONS, False)
    proc = subprocess.run([exe], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-2000:]

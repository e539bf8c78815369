"""The blind-rotation step's glue kernel (`csrc/br_glue.cu`) compiled for
the host with the stand-in CUDA runtime of `tests/test_torch_csrc_host.py`
and run against its plain twin (`TorusNttPlanU32.br_glue_plain`), bit for
bit, in all three modes (decompose only, add and decompose, add only): at
N = 256, 1024 and 2048, GLWE sizes 1 and 2, radix (3, 4), (8, 4), 23-bit
digits and 16 digits of 4 bits (all 64 bits, no rounding), with the
exponents 0, 1, N and 2N - 1 on the rows of each batch, accumulator words
near 2^63 and 2^64 - 1, residues at 0 and q - 1, digits exactly at B/2
under both carry parities and words half-way between two roundings; plus
the sizes the C entry and the shapes the wrapper refuse. Needs a C++20
compiler (g++)."""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.tfhe.poly import get_torus_plan_u32
from test_torch_csrc_host import HOST_CUDA, _compile, _host_source


@pytest.fixture(scope="module")
def br_glue(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host_br_glue"))
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(HOST_CUDA)
    lib = ctypes.CDLL(_compile(out, "br_glue", _host_source("br_glue"),
                               True))
    for fn, sig in _build.SIGNATURES["br_glue"].items():
        getattr(lib, fn).argtypes = [_build._CTYPES[c] for c in sig]
    return lib.br_glue


def _p(a):
    if a is None:
        return None
    assert a.flags.c_contiguous
    return a.ctypes.data


def _run(br_glue, plan, acc, upd, e, radix_log, count):
    """The kernel on numpy operands (None for an absent one): (acc, digits)
    as the wrapper returns them."""
    rows, comps, n = acc.shape
    k = plan.base.k
    acc_out = None if upd is None else np.empty_like(acc)
    digits = (None if e is None
              else np.empty((rows, comps * count, k, n), dtype=np.int64))
    assert br_glue(_p(acc), _p(upd), _p(e), _p(acc_out), _p(digits),
                   _p(plan.glue_tab.numpy()), rows, comps, k, count,
                   radix_log, n.bit_length() - 1, None) == 0
    return (acc if acc_out is None else acc_out), digits


def _check(br_glue, plan, acc, upd, e, radix_log, count):
    got = _run(br_glue, plan, acc, upd, e, radix_log, count)
    want = plan.br_glue(*(None if x is None else torch.from_numpy(x)
                          for x in (acc, upd, e)), radix_log, count)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w.numpy())
    return got


def _operands(rng, plan, rows, comps):
    """Random accumulator words with 0, 2^63 - 1, 2^63 and 2^64 - 1 on
    every row, random residues below each prime with 0 and q - 1 planted,
    and the exponents 0, 1, N, 2N - 1 on the rows in turn."""
    n, q = plan.n, plan.base.q.numpy()
    acc = rng.integers(-(1 << 63), (1 << 63) - 1, (rows, comps, n),
                       dtype=np.int64, endpoint=True)
    acc[..., :4] = [0, (1 << 63) - 1, -(1 << 63), -1]
    upd = rng.integers(0, 1 << 62, (rows, comps, plan.base.k, n)) % q
    upd[..., 0] = 0
    upd[..., 1] = q[:, 0] - 1
    e = np.array([(0, 1, n, 2 * n - 1)[r % 4] for r in range(rows)],
                 dtype=np.int64)
    return acc, upd, e


# (N, GLWE components, radix_log, count)
CASES = [(256, 2, 4, 3),      # the PBS radix (3, 4) at the tests' N
         (1024, 2, 4, 3),     # the benchmark's step, cut to four rows
         (2048, 2, 4, 8),     # radix (8, 4): 16 digits a step, at 2048
         (1024, 3, 4, 3),     # GLWE size 2
         (256, 2, 23, 2),     # RADIX_128's 23-bit digits
         (256, 2, 4, 16)]     # 64 bits of digits: no rounding


@pytest.mark.parametrize("n,comps,radix_log,count", CASES)
def test_br_glue_kernel_matches_twin(br_glue, n, comps, radix_log, count):
    """Each mode against the twin; then a whole chain decompose -> add and
    decompose -> add, the kernel's outputs feeding it, as a rotation runs
    it (a fresh update each step)."""
    plan = get_torus_plan_u32(n, device="cpu")
    rng = np.random.default_rng(n * 31 + comps * 7 + radix_log + count)
    acc, upd, e = _operands(rng, plan, 4, comps)
    _check(br_glue, plan, acc, None, e, radix_log, count)
    _check(br_glue, plan, acc, upd, e, radix_log, count)
    _check(br_glue, plan, acc, upd, None, radix_log, count)
    for i in range(2):
        acc, _ = _check(br_glue, plan, acc, None if i == 0 else upd,
                        np.roll(e, i), radix_log, count)
        upd = np.ascontiguousarray(np.roll(upd, 1, axis=-1))


def test_br_glue_kernel_rounds_and_carries_as_the_twin(br_glue):
    """Digits exactly at B/2 with the remaining word even and odd, at every
    digit position, carries running up through B - 1 digits, the top carry
    dropped, and differences half-way between two roundings and one below:
    on a row rotated by 1, X acc - acc holds acc[j - 1] - acc[j] at j >= 1,
    so the accumulator is the running difference of the words wanted."""
    n = 256
    plan = get_torus_plan_u32(n, device="cpu")
    for radix_log, count in ((4, 3), (4, 8), (23, 2), (4, 16)):
        total = radix_log * count
        b, half = 1 << radix_log, 1 << (radix_log - 1)
        top = []                              # the rounded words
        for pos in range(count):              # B/2 at digit `pos`
            for above in (0, 1, 2, 3, b - 1):     # its parity, a carry on
                top.append((half + above * b) * b ** pos % (1 << total))
        top += [(1 << total) - 1, 1 << (total - 1), half, b * half]
        shift = 64 - total
        diff = [0]
        for w in top:
            diff.append(w << shift)
            if shift:                         # half-way, and one below
                diff += [(w << shift) + (1 << (shift - 1)),
                         (w << shift) + (1 << (shift - 1)) - 1]
        assert len(diff) <= n
        acc_row = [0] * n
        for j in range(1, n):
            d = diff[j] if j < len(diff) else 0
            acc_row[j] = (acc_row[j - 1] - d) % (1 << 64)
        acc = np.array([[acc_row, acc_row]], dtype=np.uint64).view(np.int64)
        e = np.array([1], dtype=np.int64)
        _check(br_glue, plan, acc, None, e, radix_log, count)


def test_br_glue_entry_refuses_unsupported_sizes(br_glue):
    """N outside B1's 256..16384, more than 4 primes, digits of more than
    29 bits or beyond 64 bits in all, and inconsistent modes: the C entry
    returns cudaErrorInvalidValue."""
    x = np.zeros(1 << 15, dtype=np.int64)
    p = x.ctypes.data

    def call(upd=p, e=p, out=p, dig=p, kp=4, count=3, radix_log=4, logn=10):
        return br_glue(p, upd, e, out, dig, p, 1, 2, kp, count, radix_log,
                       logn, None)

    assert call(upd=None, out=None, e=None, dig=None) == 1
    assert call(out=None) == 1 and call(dig=None) == 1
    for bad in (dict(logn=7), dict(logn=15), dict(kp=5), dict(kp=0),
                dict(radix_log=30), dict(radix_log=0), dict(count=0),
                dict(count=17, radix_log=4), dict(count=3, radix_log=22)):
        assert call(**bad) == 1, bad


def test_br_glue_wrapper_refuses_bad_operands():
    """The wrapper checks dtype, device, shape and the radix before it runs
    anything, on the CPU as on the card."""
    n = 256
    plan = get_torus_plan_u32(n, device="cpu")
    acc = torch.zeros(3, 2, n, dtype=torch.int64)
    upd = torch.zeros(3, 2, 4, n, dtype=torch.int64)
    e = torch.zeros(3, dtype=torch.int64)
    good = (acc, upd, e, 4, 3)
    plan.br_glue(*good)
    bad = [(acc, None, None, 4, 3),                         # nothing to do
           (acc.to(torch.int32), upd, e, 4, 3),             # dtype
           (acc, upd.to(torch.float64), e, 4, 3),
           (acc, upd, e.to(torch.int32), 4, 3),
           (acc[..., :128], upd, e, 4, 3),                  # N
           (acc, upd[:, :, :3], e, 4, 3),                   # primes
           (acc, upd[:2], e, 4, 3),                         # rows
           (acc, upd, e[:2], 4, 3),
           (acc, upd, e.reshape(3, 1), 4, 3),
           (acc[0, 0], upd, e, 4, 3),                       # no C axis
           (acc, upd, e, 30, 2), (acc, upd, e, 0, 3),       # radix
           (acc, upd, e, 4, 0), (acc, upd, e, 4, 17),
           (acc.to("meta"), upd, e, 4, 3)]                  # device
    for args in bad:
        with pytest.raises(ValueError):
            plan.br_glue(*args)

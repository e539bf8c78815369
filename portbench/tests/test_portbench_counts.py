"""The frozen counts against values worked by hand, the plain references
against naive arithmetic, and the chi_sq traffic's count range against
the plain modulus it runs under."""

import numpy as np
import torch

from portbench import harness, peaks
from portbench.counts import _bfv, bfv_mul_relin, bfv_program, \
    bfv_rotsum, tfhe_pbs
from portbench.reference import bfv as rbfv
from portbench.reference import chi_sq as rchi
from portbench.reference import tfhe as rtfhe
from portbench.tests import tiny


def _spec(workload):
    return harness.load_spec(tiny.ROOT, workload)


def test_bfv_counts_at_n8192():
    spec = _spec("bfv8192.mul_relin.b64")
    config, traffic = spec["config"], spec["traffic"]
    # Q: 26 + 6 x 27 = 188 bits; t 20 bits, N 14 bits: 224 bits of
    # auxiliary base, 8 primes of 30 bits
    assert _bfv.shape(config, 1032193) == (8192, 7, 8, 8)
    assert _bfv.ntt_muls(8192) == 3 * 4096 * 13 == 159744
    # convert 32768 x 198 + tensor 15 x 704512 + inverse 45 x 184320
    # + scale 24576 x 596
    assert _bfv.multiply_muls(config, 1032193) == (
        6488064 + 10567680 + 8294400 + 14647296)
    # 7 x 8 transforms + 8 x (4 x 7 x 8192 + 2 x 184320) + 2 x 8192 x 14
    assert _bfv.keyswitch_muls(config, 1032193) == (
        8945664 + 4784128 + 229376)
    nbytes, muls = bfv_mul_relin.work(config, traffic)
    assert muls == 64 * (39997440 + 13959168) == 3453222912
    # 3 x 64 ciphertexts of 2 x 7 x 8192 words, a key of 2 x 7 x 8 x 8192
    assert nbytes == 3 * 64 * 917504 + 7340032 == 183500800
    assert peaks.least_seconds(nbytes, muls) == muls / 16.75e12


def test_rotsum_and_program_counts():
    spec = _spec("bfv8192.rotsum.b256")
    nbytes, muls = bfv_rotsum.work(spec["config"], spec["traffic"])
    assert muls == 256 * 13 * 13959168
    assert nbytes == 2 * 256 * 917504 + 13 * 7340032
    spec = _spec("bfv8192.chi_sq.b128")
    nodes = bfv_program.nodes("chi_sq")
    assert (nodes["multiply"], nodes["relinearize"],
            nodes["multiply_plain"]) == (6, 6, 5)
    nbytes, muls = bfv_program.work(spec["config"], spec["traffic"])
    mp = 2 * 7 * 159744 + 4 * 7 * 8192 + 2 * 7 * 184320
    # t = 64 at N = 8192: 7 + 14 + 188 + 2 bits, still 8 auxiliary primes
    assert muls == (128 * (6 * 39997440 + 6 * 13959168 + 5 * mp)
                    + 5 * 7 * 159744)
    assert nbytes == 128 * 7 * 917504 + 7340032 + 2 * 8192 * 8


def test_pbs_counts_at_the_preset():
    spec = _spec("tfhe80.pbs.b2048")
    nbytes, muls = tfhe_pbs.work(spec["config"], spec["traffic"])
    # a step: 6 digit transforms x 4 primes (368640), their contraction
    # 4 x 2 x 2 x 6 x 1024 (98304), 2 inverse transforms x 4 primes with
    # the 1/N scale (147456); the keyswitch: 1024 x 8 digits x 513 words
    step = 368640 + 98304 + 147456
    keyswitch = 1024 * 8 * 513 * 4
    assert muls == 2048 * (512 * step + keyswitch) == 678671941632
    assert nbytes == 8 * (2 * 2048 * 513 + 512 * 2 * 3 * 2 * 1024
                          + 1024 * 8 * 513 + 1024)


def _naive_negacyclic(a, b, q):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            out[k % n] += a[i] * b[j] * (1 if k < n else -1)
    return [x % q for x in out]


def test_reference_ntt_against_schoolbook():
    g = torch.Generator().manual_seed(3)
    moduli = (7681, 12289, 268369921)
    ntt = rbfv.NegacyclicNtt(32, moduli, "cpu")
    a = torch.randint(0, 7681, (2, 3, 32), generator=g)
    b = torch.randint(-1, 2, (2, 3, 32), generator=g)
    got = ntt.multiply(a, b)
    for r in range(2):
        for i, q in enumerate(moduli):
            assert got[r, i].tolist() == _naive_negacyclic(
                a[r, i].tolist(), b[r, i].tolist(), q)


def test_full_rotation_sum_is_n_times_the_constant_term():
    n, t = 16, 97
    p = torch.randint(0, t, (3, n), generator=torch.Generator().manual_seed(1))
    acc = p
    for s in (1, 2, 4):
        acc = (acc + rbfv.automorphism(acc, rbfv.row_rotation_element(s, n),
                                       t)) % t
    acc = (acc + rbfv.automorphism(acc, rbfv.column_swap_element(n), t)) % t
    want = torch.zeros_like(p)
    want[:, 0] = n * p[:, 0] % t
    assert acc.equal(want)


def test_lwe_decode():
    words = torch.tensor([0, 1 << 61, (1 << 62) + 5, -(1 << 63), -1])
    assert rtfhe.decode(words, 1).tolist() == [0, 0, 1, 1, 0]
    assert rtfhe.decode(rtfhe.encode(torch.tensor([0, 1, 2, 3]), 2),
                        2).tolist() == [0, 1, 2, 3]


def _signed_poly(v):
    return np.array([int(c) for c in bin(v)[2:][::-1]], dtype=np.int64)


def test_chi_sq_counts_stay_inside_the_plain_modulus():
    """Every output coefficient of chi_sq over Z[x], for every triple in
    the traffic's count range, lies in (-t/2, t/2]: so the outputs mod t
    decode to the plain integers the reference compares."""
    traffic = _spec("bfv8192.chi_sq.b128")["traffic"]
    t = traffic["plain_modulus"]
    lo, hi = traffic["count_range"]
    x, x2 = np.array([0, 1]), np.array([0, 0, 1])
    mul = np.convolve

    def add(a, b):
        out = np.zeros(max(len(a), len(b)), dtype=np.int64)
        out[:len(a)] += a
        out[:len(b)] += b
        return out

    for n0 in range(lo, hi + 1):
        for n1 in range(lo, hi + 1):
            for n2 in range(lo, hi + 1):
                e0, e1, e2 = map(_signed_poly, (n0, n1, n2))
                a = add(mul(mul(x2, e0), e2), -mul(e1, e1))
                s1, s3 = add(mul(x, e0), e1), add(mul(x, e2), e1)
                outs = (mul(a, a), mul(x, mul(s1, s1)), mul(s1, s3),
                        mul(x, mul(s3, s3)))
                for poly, want in zip(outs, rchi.expected(n0, n1, n2)):
                    assert -t // 2 < poly.min() and poly.max() <= t // 2
                    assert rchi.decode_signed(poly % t, t) == want

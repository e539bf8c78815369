"""The u32 NTT plan's round trip, twiddle tables, flat domain order,
launch-free CPU path and `get_plan`'s envelope (the plans and helpers of
test_torch_pmntt.py)."""

import numpy as np
import pytest
import torch

from sunscreen_tpu.math import ntt as rntt
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import ntt as pntt
from sunscreen_tpu_torch.math import pmntt
from test_torch_pmntt import _residues, _t, plans


def test_roundtrip_and_negacyclic(plans):
    n, mods, _, port = plans
    rng = np.random.default_rng(n + 5)
    x = _t(_residues(rng, mods, (3,), n))
    assert torch.equal(port.inv(port.fwd(x)), x)
    a = _residues(rng, mods, (), n).astype(np.int64)
    b = _residues(rng, mods, (), n).astype(np.int64)
    got = port.negacyclic_mul(_t(a), _t(b)).numpy()
    for li, q in enumerate(mods):       # numpy negacyclic oracle, per limb
        want = np.zeros(n, dtype=object)
        for i in range(n):
            prod = a[li, i].item() * b[li].astype(object)
            want[i:] += prod[:n - i]
            want[:i] -= prod[n - i:]
        np.testing.assert_array_equal(got[li], (want % q).astype(np.int64))


def test_twiddle_pairs_match_tw_and_reference(plans):
    """The transform kernels' table [k, 2, N] (w | w_sh << 32 per entry)
    holds the radix-2 table tw's psi_rev and ipsi_rev rows beside their
    Shoup ratios, and those are the reference NttPlan's u32 tables."""
    n, mods, _, port = plans
    pairs = port.twp.numpy().view(np.uint64)
    assert pairs.shape == (len(mods), 2, n)
    lo = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (pairs >> np.uint64(32)).astype(np.uint32)
    tw = pmntt.kernel_tables(n, mods)[2].view(np.uint32)
    np.testing.assert_array_equal(lo, tw[:, 0::2])
    np.testing.assert_array_equal(hi, tw[:, 1::2])
    ref = rntt.NttPlan(n, mods)
    for row, name in enumerate(("psi_rev", "ipsi_rev")):
        np.testing.assert_array_equal(lo[:, row],
                                      np.asarray(getattr(ref, name)))
        np.testing.assert_array_equal(hi[:, row],
                                      np.asarray(getattr(ref, name + "_sh")))


def test_flat_domain_layout_oracle():
    """Flat position j2*n1 + j1 holds the evaluation at psi*omega^J with
    J = j2 + 128*j1 (python ints, independent of both packages)."""
    n = 256
    mods = tuple(rprimes.gen_ntt_primes(29, 2, n))
    port = pmntt.NttPlanU32(n, mods, "cpu")
    x = _residues(np.random.default_rng(9), mods, (), n)
    got = port.fwd(_t(x)).numpy()
    n1 = n // 128
    for li, q in enumerate(mods):
        psi = rprimes.min_root_of_unity(2 * n, q)
        coeffs = [int(v) for v in x[li]]
        for p in range(0, n, 7):
            j2, j1 = divmod(p, n1)
            pt = psi * pow(psi * psi, j2 + 128 * j1, q) % q
            want = sum(c * pow(pt, i, q) for i, c in enumerate(coeffs)) % q
            assert got[li, p] == want, (li, p)


def test_cpu_tensors_never_launch():
    n = 256
    mods = tuple(rprimes.gen_ntt_primes(29, 2, n))
    port = pmntt.NttPlanU32(n, mods, "cpu")
    _build.reset_launches()
    x = _t(_residues(np.random.default_rng(1), mods, (1,), n))
    port.inv(port.fwd(x))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_get_plan_envelope():
    """The plan cache, the u32 kernels' N <= 16384 bound, and the u64
    engine's plans where the u32 plans end: moduli above 30 bits (the
    CPU default "unrolled") and N below 256 ("matmul", as the reference
    degrades "pallas")."""
    mods = tuple(rprimes.gen_ntt_primes(29, 2, 256))
    assert pntt.get_plan(256, mods, "cpu") is pntt.get_plan(256, mods, "cpu")
    with pytest.raises(Unsupported):
        pntt.get_plan(32768, tuple(rprimes.gen_ntt_primes(29, 1, 32768)),
                      "cpu")
    wide = pntt.get_plan(256, tuple(rprimes.gen_ntt_primes(40, 1, 256)),
                         "cpu")
    assert type(wide) is pntt.NttPlan and wide.mode == "unrolled"
    small = pntt.get_plan(128, tuple(rprimes.gen_ntt_primes(29, 1, 128)),
                          "cpu")
    assert small.mode == "matmul"

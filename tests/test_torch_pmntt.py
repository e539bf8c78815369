"""The port's u32 NTT plan (sunscreen_tpu_torch.math.pmntt) against the
JAX package's PallasMatmulNttPlan (interpret mode on the CPU) and a
python-int oracle, bit for bit. On CPU tensors every entry point runs its
plain PyTorch twin; the CUDA kernels are held against the same twins by
chip_smoke.py on the card."""

import jax  # noqa: F401  (conftest pins the CPU first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.math import ntt as rntt
from sunscreen_tpu.math import pmntt as rpmntt
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import ntt as pntt
from sunscreen_tpu_torch.math import pmntt


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _residues(rng, moduli, lead, n):
    return np.stack([rng.integers(0, q, lead + (n,)) for q in moduli],
                    axis=-2).astype(np.uint32)


@pytest.fixture(scope="module", params=[256, 512, 1024])
def plans(request):
    n = request.param
    mods = tuple(rprimes.gen_ntt_primes(29, 3, n))
    return n, mods, rpmntt.PallasMatmulNttPlan(n, mods), \
        pmntt.NttPlanU32(n, mods, "cpu")


def test_fwd_matches_reference(plans):
    n, mods, ref, port = plans
    x = _residues(np.random.default_rng(n), mods, (2,), n)
    np.testing.assert_array_equal(port.fwd(_t(x)).numpy(),
                                  np.asarray(ref.fwd(jnp.asarray(x))))


def test_inv_matches_reference(plans):
    n, mods, ref, port = plans
    x = _residues(np.random.default_rng(n + 1), mods, (2,), n)
    np.testing.assert_array_equal(port.inv(_t(x)).numpy(),
                                  np.asarray(ref.inv(jnp.asarray(x))))


def test_fwd_broadcast_full_range_u32(plans):
    """Raw digits over the whole u32 range, above every modulus."""
    n, mods, ref, port = plans
    rng = np.random.default_rng(n + 2)
    d = rng.integers(0, 1 << 32, (2, 3, n), dtype=np.uint64)
    d[0, 0, :4] = (1 << 32) - 1
    d = d.astype(np.uint32)
    np.testing.assert_array_equal(
        port.fwd_broadcast(_t(d)).numpy(),
        np.asarray(ref.fwd_broadcast(jnp.asarray(d))))


def test_fwd_tensor3_matches_reference(plans):
    n, mods, ref, port = plans
    ext = _residues(np.random.default_rng(n + 3), mods, (2, 4), n)
    np.testing.assert_array_equal(
        port.fwd_tensor3(_t(ext)).numpy(),
        np.asarray(ref.fwd_tensor3(jnp.asarray(ext), full=False)))


def test_inv_tensor3_matches_reference(plans):
    """B12's twin against the reference plan's inv_tensor3; the operands
    also as the two halves of one [rows, 4, k, N] stack, as the multiply
    passes them."""
    n, mods, ref, port = plans
    rng = np.random.default_rng(n + 6)
    both = _residues(rng, mods, (2, 4), n)
    a, b = both[:, :2], both[:, 2:]
    want = np.asarray(ref.inv_tensor3(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(port.inv_tensor3(_t(a), _t(b)).numpy(),
                                  want)
    stack = _t(both)
    np.testing.assert_array_equal(
        port.inv_tensor3(stack[:, :2], stack[:, 2:]).numpy(), want)


def test_inv_ks_matches_reference(plans):
    """kdig = 9 digits: past the point where int64 sums of unreduced
    products would overflow."""
    n, mods, ref, port = plans
    rng = np.random.default_rng(n + 4)
    kdig = 9
    d = _residues(rng, mods, (2, kdig), n)
    k0 = _residues(rng, mods, (kdig,), n)
    k1 = _residues(rng, mods, (kdig,), n)
    np.testing.assert_array_equal(
        port.inv_ks(_t(d), _t(k0), _t(k1)).numpy(),
        np.asarray(ref.inv_ks(jnp.asarray(d), jnp.asarray(k0),
                              jnp.asarray(k1))))


@pytest.mark.parametrize("name", ["ks_full", "ks_full_limbs"])
def test_ks_full_twins_match_reference(name):
    """The twins of B14 and B15 against the reference plan's `ks_full`
    (raw u32 digits over the whole range, above every modulus) and
    `ks_full_limbs` (per-limb residues, one digit row at q - 1), at
    N=256; the wrappers take the twins for CPU tensors."""
    n, kdig = 256, 4
    mods = tuple(rprimes.gen_ntt_primes(30, 3, n))
    ref = rpmntt.PallasMatmulNttPlan(n, mods)
    port = pmntt.NttPlanU32(n, mods, "cpu")
    rng = np.random.default_rng(31)
    k0 = _residues(rng, mods, (kdig,), n)
    k1 = _residues(rng, mods, (kdig,), n)
    k0[0] = np.array(mods, dtype=np.uint32)[:, None] - 1
    if name == "ks_full":
        d = rng.integers(0, 1 << 32, (2, kdig, n), dtype=np.uint64)
        d[0, 0] = (1 << 32) - 1
        d = d.astype(np.uint32)
    else:
        d = _residues(rng, mods, (2, kdig), n)
        d[1, 1] = np.array(mods, dtype=np.uint32)[:, None] - 1
    want = np.asarray(getattr(ref, name)(jnp.asarray(d), jnp.asarray(k0),
                                         jnp.asarray(k1)))
    _build.reset_launches()
    for fn in (getattr(port, name), getattr(port, name + "_plain")):
        np.testing.assert_array_equal(fn(_t(d), _t(k0), _t(k1)).numpy(),
                                      want)
    assert all(v == 0 for v in _build.LAUNCHES.values())


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

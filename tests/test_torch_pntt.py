"""The port's "pallas_vpu" NTT plan (sunscreen_tpu_torch.math.pntt), its
kernel tables, the B13 twin and the port's NTT mode selection, against
the JAX package (Pallas in interpret mode on the CPU), bit for bit. On
CPU tensors every entry point runs its plain PyTorch twin; the CUDA
kernels are held against the same twins by chip_smoke.py on the card."""

import jax  # noqa: F401  (conftest pins the CPU first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.math import ntt as rntt
from sunscreen_tpu.math import pmntt as rpmntt
from sunscreen_tpu.math import pntt as rpntt
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import BfvParams, get_context
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import mntt, ntt, pmntt, pntt


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _residues(rng, moduli, lead, n):
    return np.stack([rng.integers(0, q, lead + (n,)) for q in moduli],
                    axis=-2).astype(np.uint32)


def _moduli(n):
    """Two 29-bit limbs and one 18-bit limb, the smallest the plan takes."""
    return (tuple(rprimes.gen_ntt_primes(29, 2, n))
            + tuple(rprimes.gen_ntt_primes(18, 1, n)))


@pytest.mark.parametrize("n", [128, 256])
def test_plan_matches_reference(n):
    """fwd, inv and the broadcasting pointwise_mul against the reference's
    PallasNttPlan: the NTT-domain arrays index for index (N=128 is the
    C = 64, R = 2 layout); the wrappers take the twins for CPU tensors
    and launch nothing."""
    mods = _moduli(n)
    ref = rpntt.PallasNttPlan(n, mods)
    port = pntt.PallasNttPlan(n, mods, "cpu")
    assert (port.R, port.C, port.mode) == (ref.R, ref.C, "pallas_vpu")
    rng = np.random.default_rng(n)
    x = _residues(rng, mods, (2, 3), n)
    y = _residues(rng, mods, (), n)
    _build.reset_launches()
    fwd = port.fwd(_t(x))
    np.testing.assert_array_equal(fwd.numpy(),
                                  np.asarray(ref.fwd(jnp.asarray(x))))
    np.testing.assert_array_equal(port.inv(_t(x)).numpy(),
                                  np.asarray(ref.inv(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port.pointwise_mul(_t(x), _t(y)).numpy(),
        np.asarray(ref.pointwise_mul(jnp.asarray(x), jnp.asarray(y))))
    assert torch.equal(port.inv(fwd), _t(x))
    assert torch.equal(port.fwd_plain(_t(x)), fwd)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_plan_above_16384_matches_reference():
    """At N = 32768, past the reference's "pallas" plans, the port's
    "pallas_vpu" plan computes on the CPU as the reference's does: fwd,
    inv and negacyclic_mul on one row of two 28-bit limbs, bit for bit.
    "pallas" stays a named raise there, as the reference asserts
    (pmntt.py:782), and so does "pallas_vpu" on CUDA above the largest N
    the B16 kernels hold (2^21, in two passes)."""
    n = 32768
    mods = tuple(rprimes.gen_ntt_primes(28, 2, n))
    ref = rpntt.PallasNttPlan(n, mods)
    port = ntt.get_plan(n, mods, "cpu", "pallas_vpu")
    rng = np.random.default_rng(n)
    x, y = (_residues(rng, mods, (1,), n) for _ in range(2))
    np.testing.assert_array_equal(port.fwd(_t(x)).numpy(),
                                  np.asarray(ref.fwd(jnp.asarray(x))))
    np.testing.assert_array_equal(port.inv(_t(x)).numpy(),
                                  np.asarray(ref.inv(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port.negacyclic_mul(_t(x), _t(y)).numpy(),
        np.asarray(ref.negacyclic_mul(jnp.asarray(x), jnp.asarray(y))))
    with pytest.raises(Unsupported, match="pallas"):
        ntt.get_plan(n, mods, "cpu", "pallas")
    big = 2 * pntt.KERNEL_MAX_N
    with pytest.raises(Unsupported, match="B16"):
        pntt.PallasNttPlan(big, tuple(rprimes.gen_ntt_primes(28, 1, big)),
                           "cuda")


def test_plan_at_65536_matches_reference():
    """At N = 65536, where B16 runs as two kernels a transform on CUDA
    (R = 512 rows), the port's CPU plan computes as the reference's
    PallasNttPlan does: fwd, inv and negacyclic_mul on one row of one
    28-bit limb, bit for bit; the passes' twins, which the CPU wrappers
    of the two passes take, compose to fwd and inv."""
    n = 65536
    mods = tuple(rprimes.gen_ntt_primes(28, 1, n))
    ref = rpntt.PallasNttPlan(n, mods)
    port = pntt.PallasNttPlan(n, mods, "cpu")
    assert (port.R, port.C) == (ref.R, ref.C) == (512, 128)
    rng = np.random.default_rng(n)
    x, y = (_residues(rng, mods, (1,), n) for _ in range(2))
    _build.reset_launches()
    fwd = port.fwd(_t(x))
    np.testing.assert_array_equal(fwd.numpy(),
                                  np.asarray(ref.fwd(jnp.asarray(x))))
    inv = port.inv(_t(x))
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(ref.inv(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port.negacyclic_mul(_t(x), _t(y)).numpy(),
        np.asarray(ref.negacyclic_mul(jnp.asarray(x), jnp.asarray(y))))
    assert torch.equal(port.fwd_cols(port.fwd_rows(_t(x))), fwd)
    assert torch.equal(port.inv_rows(port.inv_cols(_t(x))), inv)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_kernel_order_matches_twin():
    """What B16 computes, emulated on the CPU: the radix-2 transform in
    natural order in, bit-reversed order out (the u64 plan's stages, the
    same as transform.cuh's), read at slot (p % R) C + p // R for position
    p (the kernel's rotation of the slot's bits), is the twin's output;
    the inverse scatters through the same map at load. That slot is
    brev(J(p)) for the closed form J = brev(s') + R brev(t'), and the
    monomial x confirms J."""
    for n in (128, 256, 1024):
        mods = _moduli(n)
        port = pntt.PallasNttPlan(n, mods, "cpu")
        radix2 = ntt.NttPlan(n, mods, "cpu")
        x = _t(_residues(np.random.default_rng(n + 1), mods, (2,), n))
        p = np.arange(n)
        slot = (p % port.R) * port.C + p // port.R
        np.testing.assert_array_equal(slot, pmntt._bitrev(n)[port.slot_j])
        pos = torch.from_numpy(slot)
        want = port.fwd_plain(x)
        assert torch.equal(radix2.fwd(x)[..., pos], want)
        scattered = torch.empty_like(want)
        scattered[..., pos] = want
        assert torch.equal(radix2.inv(scattered), x)
        assert sorted(slot.tolist()) == list(range(n))
        mono = torch.zeros(len(mods), n, dtype=torch.int64)
        mono[:, 1] = 1
        evals = port.fwd_plain(mono)
        for li, q in enumerate(mods):
            psi = rprimes.min_root_of_unity(2 * n, q)
            for p in range(0, n, 5):
                assert evals[li, p] == pow(psi, 2 * int(port.slot_j[p]) + 1,
                                           q)


def test_pointwise_strides_cover_broadcasts():
    """The leading dims B17 reads through strides: merged where both
    operands allow, and the kernel's row offsets (emulated) pick the same
    residues as torch's broadcast."""
    k, n = 2, 8
    cases = [((4, 3, k, n), (k, n)), ((4, 2, k, n), (4, 1, k, n)),
             ((5, k, n), (5, k, n)), ((2, 1, 3, k, n), (2, 4, 1, k, n))]
    for sa, sb in cases:
        a = torch.arange(int(np.prod(sa))).reshape(sa)
        b = torch.arange(int(np.prod(sb))).reshape(sb) * 1000
        shape = torch.broadcast_shapes(a.shape, b.shape)
        ae, be = a.expand(shape), b.expand(shape)
        lead = pntt._merge_lead(shape[:-2], ae.stride()[:-2],
                                be.stride()[:-2])
        assert len(lead) <= pntt.LEAD_DIMS
        rows = int(np.prod(shape[:-2]))
        want = (ae + be).reshape(rows, k * n)
        for row in range(rows):
            oa = ob = 0
            r = row
            for size, s_a, s_b in reversed(lead):
                oa, ob, r = oa + r % size * s_a, ob + r % size * s_b, \
                    r // size
            got = a.flatten()[oa:oa + k * n] + b.flatten()[ob:ob + k * n]
            assert torch.equal(got, want[row]), (sa, sb, row)


def test_fwd_tensor3_full_matches_reference():
    """B13's twin (the three inverse transforms after B4) against the
    reference's `fwd_tensor3(full=True)`; the CPU wrapper takes it."""
    n = 256
    mods = tuple(rprimes.gen_ntt_primes(29, 3, n))
    ref = rpmntt.PallasMatmulNttPlan(n, mods)
    port = pmntt.NttPlanU32(n, mods, "cpu")
    ext = _residues(np.random.default_rng(13), mods, (2, 4), n)
    want = np.asarray(ref.fwd_tensor3(jnp.asarray(ext), full=True))
    _build.reset_launches()
    np.testing.assert_array_equal(
        port.fwd_tensor3(_t(ext), full=True).numpy(), want)
    np.testing.assert_array_equal(port.fwd_tensor3_full_plain(_t(ext)).numpy(),
                                  want)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_degrade_rules_match_reference(monkeypatch):
    """The mode `get_plan` settles on, against the reference's get_plan
    (its plan constructor stubbed to return the mode), over the modes,
    sizes and modulus widths around every rule; the port builds a plan
    of that mode in every case."""
    monkeypatch.setattr(rntt, "_plan_cached", lambda n, mods, mode: mode)
    widths = {"w16": (16,), "w18": (18, 29), "w29": (29, 30), "w40": (40,),
              "w60": (60,)}
    kinds = {"pallas": pmntt.NttPlanU32, "pallas_vpu": pntt.PallasNttPlan,
             "unrolled": ntt.NttPlan, "compact": ntt.NttPlan,
             "matmul": mntt.MatmulNttPlan}
    for mode in ("pallas", "pallas_vpu", "unrolled", "matmul", "compact"):
        for n in (128, 256):
            for bits in widths.values():
                mods = tuple(rprimes.gen_ntt_primes(b, 1, n)[0]
                             for b in bits)
                want = rntt.get_plan(n, mods, mode)
                assert ntt.degrade(n, mods, mode) == want, (mode, n, bits)
                plan = ntt.get_plan(n, mods, "cpu", mode)
                assert type(plan) is kinds[want] and plan.mode == want


def test_resolve_mode_reads_settings(monkeypatch):
    """The argument, then SUNSCREEN_TPU_NTT, then the legacy
    SUNSCREEN_TPU_COMPACT_NTT=1, then the device's default: "pallas",
    except "unrolled" on the CPU for moduli above 30 bits, the
    reference's CPU default, so that the golden u64 vectors come out
    under default settings (a BFV context takes it for its moduli)."""
    monkeypatch.delenv("SUNSCREEN_TPU_NTT", raising=False)
    monkeypatch.delenv("SUNSCREEN_TPU_COMPACT_NTT", raising=False)
    assert ntt.resolve_mode() == "pallas"
    wide = tuple(rprimes.gen_ntt_primes(40, 2, 256))
    narrow = tuple(rprimes.gen_ntt_primes(29, 2, 256))
    assert ntt.resolve_mode(None, "cpu", wide) == "unrolled"
    assert ntt.resolve_mode(None, "cpu", narrow) == "pallas"
    assert ntt.resolve_mode(None, None, wide) == "pallas"
    assert ntt.degrade(256, wide, ntt.resolve_mode(None, None, wide)) \
        == "matmul"
    assert type(ntt.get_plan(256, wide, "cpu")) is ntt.NttPlan
    u64_ctx = get_context(BfvParams.insecure(256, limbs=2), "cpu")
    assert (u64_ctx.mode, u64_ctx.plan_key.mode) == ("unrolled", "unrolled")
    monkeypatch.setenv("SUNSCREEN_TPU_COMPACT_NTT", "1")
    assert ntt.resolve_mode() == "compact"
    monkeypatch.setenv("SUNSCREEN_TPU_NTT", "pallas_vpu")
    assert ntt.resolve_mode() == "pallas_vpu"
    assert ntt.resolve_mode("pallas") == "pallas"
    mods = tuple(rprimes.gen_ntt_primes(29, 2, 256))
    assert isinstance(ntt.get_plan(256, mods, "cpu"), pntt.PallasNttPlan)
    with pytest.raises(ValueError, match="unknown NTT mode"):
        ntt.get_plan(256, mods, "cpu", "fft")

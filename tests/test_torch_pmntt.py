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

from sunscreen_tpu.math import pmntt as rpmntt
from sunscreen_tpu.math import primes as rprimes
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

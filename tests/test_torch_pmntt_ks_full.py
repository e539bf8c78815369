"""The plain twins of B14 and B15 (`ks_full`, `ks_full_limbs`) against
the JAX package's PallasMatmulNttPlan in interpret mode, bit for bit (the
helpers of test_torch_pmntt.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sunscreen_tpu.math import pmntt as rpmntt
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import pmntt
from test_torch_pmntt import _residues, _t


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

"""The u32 NTT plan's fused entry points (`fwd_tensor3`, `inv_tensor3`,
`inv_ks`) against the JAX package's PallasMatmulNttPlan in interpret mode,
bit for bit, at N = 256, 512 and 1024 (the plans and helpers of
test_torch_pmntt.py)."""

import jax.numpy as jnp
import numpy as np

from test_torch_pmntt import _residues, _t, plans


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

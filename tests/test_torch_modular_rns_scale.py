"""The port's decryption scaler and special-prime mod-down (`math/rns.py`)
against the JAX package's, bit for bit (the helpers of
test_torch_modular_rns.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sunscreen_tpu.math import rns as rrns
from sunscreen_tpu_torch.math import rns as prns
from test_torch_modular_rns import N, _bases, _np, _residues, _t


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t", [17, 1032193])
def test_decrypt_scaler(k, t):
    rng = np.random.default_rng(30 + k)
    qs, _ = _bases(k)
    ref = rrns.DecryptScaler(rrns.RnsBase(qs), t)
    port = prns.DecryptScaler(prns.RnsBase(qs, "cpu"), t)
    x = _residues(rng, qs, (2,))
    want, (wf_h, wf_l) = ref.apply(jnp.asarray(x))
    got, (gf_h, gf_l) = port.apply(_t(x))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(gf_h.numpy(), _np(wf_h))
    np.testing.assert_array_equal(gf_l.numpy(), _np(wf_l))


@pytest.mark.parametrize("k", [3, 7])
def test_mod_down(k):
    rng = np.random.default_rng(40 + k)
    qs, aux = _bases(k)
    p = aux[0]
    ref = rrns.ModDown(rrns.RnsBase(qs), p)
    port = prns.ModDown(prns.RnsBase(qs, "cpu"), p)
    x = _residues(rng, qs, (2,))
    xp = rng.integers(0, p, (2, N)).astype(np.uint32)
    np.testing.assert_array_equal(
        port.apply(_t(x), _t(xp)).numpy(),
        _np(ref.apply(jnp.asarray(x), jnp.asarray(xp))))

"""The port's 128-bit fixed-point dot, base converter and scale-and-round
(`math/rns.py`) against the JAX package's, bit for bit (the helpers of
test_torch_modular_rns.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sunscreen_tpu.math import rns as rrns
from sunscreen_tpu_torch.math import rns as prns
from test_torch_modular_rns import N, _bases, _np, _residues, _t, _u64


@pytest.mark.parametrize("add_half", [False, True])
def test_fixed_point_dot(add_half):
    """phi words are full 64-bit, y full 30-bit: every column carries."""
    rng = np.random.default_rng(3)
    k = 7
    y = rng.integers(0, 1 << 30, (2, k, N), dtype=np.uint64)
    y[0, :, :8] = (1 << 30) - 1
    ph, pl = _u64(rng, k), _u64(rng, k)
    ph[0] = pl[0] = np.uint64((1 << 64) - 1)
    (wi_h, wi_l), (wf_h, wf_l) = rrns.fixed_point_dot(
        jnp.asarray(y), jnp.asarray(ph), jnp.asarray(pl), add_half)
    (gi_h, gi_l), (gf_h, gf_l) = prns.fixed_point_dot(
        _t(y), _t(ph).reshape(k, 1), _t(pl).reshape(k, 1), add_half)
    for got, want in ((gi_h, wi_h), (gi_l, wi_l), (gf_h, wf_h),
                      (gf_l, wf_l)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("centered", [False, True])
def test_base_converter(k, centered):
    rng = np.random.default_rng(10 * k + centered)
    qs, aux = _bases(k)
    ref = rrns.BaseConverter(rrns.RnsBase(qs), rrns.RnsBase(aux))
    port = prns.BaseConverter(prns.RnsBase(qs, "cpu"),
                              prns.RnsBase(aux, "cpu"))
    x = _residues(rng, qs, (2,))
    x[0, :, :4] = 0                    # small values at both ends
    x[1, :, :4] = np.array(qs, np.uint32)[:, None] - 1
    np.testing.assert_array_equal(
        port.convert(_t(x), centered=centered).numpy(),
        _np(ref.convert(jnp.asarray(x), centered=centered)))
    np.testing.assert_array_equal(
        port.extend(_t(x), centered=centered).numpy(),
        _np(ref.extend(jnp.asarray(x), centered=centered)))


@pytest.mark.parametrize("k", [3, 7])
def test_scale_and_round(k):
    rng = np.random.default_rng(20 + k)
    qs, aux = _bases(k)
    t = 65537
    ref = rrns.ScaleAndRound(rrns.RnsBase(qs + aux), rrns.RnsBase(qs),
                             rrns.RnsBase(aux), t)
    port = prns.ScaleAndRound(prns.RnsBase(qs + aux, "cpu"),
                              prns.RnsBase(qs, "cpu"),
                              prns.RnsBase(aux, "cpu"), t)
    x = _residues(rng, qs + aux, (2,))
    np.testing.assert_array_equal(port.apply(_t(x)).numpy(),
                                  _np(ref.apply(jnp.asarray(x))))

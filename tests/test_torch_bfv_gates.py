"""The port's `multiply_relin` against tests/golden_u32_v1.npz under the
default settings and each of the reference's fusion settings, bit for bit
(the reference's keys carried over by the fixtures of test_torch_bfv.py)."""

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import ops
from test_torch_bfv import golden, port, reference  # noqa: F401 (port's)


def test_multiply_relin_matches_golden(golden, port):
    ctx, sk, rlk, _ = port
    ct = torch.from_numpy(golden["ct"].astype(np.int64))
    prod = ops.multiply_relin(ctx, ct, ct, rlk)
    np.testing.assert_array_equal(prod.numpy(), golden["mul_relin"])
    np.testing.assert_array_equal(ops.decrypt(ctx, sk, prod).numpy(),
                                  golden["dec_mul"])
    assert float(ops.invariant_noise_budget(ctx, sk, prod)) == \
        float(golden["noise_budget"][0])


GATES = {
    "default": {},
    "ft3_off": {"SUNSCREEN_TPU_FUSE_FT3": "0"},
    "t3": {"SUNSCREEN_TPU_FUSE_FT3": "0", "SUNSCREEN_TPU_FUSE_T3": "1"},
    "sc_off": {"SUNSCREEN_TPU_FUSE_SC": "0"},
    "ks_off": {"SUNSCREEN_TPU_FUSE_KS": "0"},
    "inv_off": {"SUNSCREEN_TPU_FUSE_INV": "0"},
    "ft3_sc_ks_off": {"SUNSCREEN_TPU_FUSE_FT3": "0",
                      "SUNSCREEN_TPU_FUSE_SC": "0",
                      "SUNSCREEN_TPU_FUSE_KS": "0"},
    "ksfull": {"SUNSCREEN_TPU_FUSE_KSFULL": "1"},
}


@pytest.mark.parametrize("gate", list(GATES))
def test_gates_match_golden(golden, port, monkeypatch, gate):
    """Under each of the reference's fusion settings the port's route
    reproduces `mul_relin` and `dec_mul` bit for bit (the reference's keys
    were built by the module fixture, before any setting). Each setting
    takes the routes the reference would."""
    ctx, sk, rlk, _ = port
    ct = torch.from_numpy(golden["ct"].astype(np.int64))
    for name, value in GATES[gate].items():
        monkeypatch.setenv(name, value)
    want_routes = {
        "default": ("fwd_tensor3", "scale_convert", "inv_ks"),
        "ft3_off": ("tensor3", "scale_convert", "inv_ks"),
        "t3": ("inv_tensor3", "scale_convert", "inv_ks"),
        "sc_off": ("fwd_tensor3", "scale", "inv_ks"),
        "ks_off": ("fwd_tensor3", "scale_convert", "ks_inner"),
        "inv_off": ("tensor3", "scale_convert", "ks_inner"),
        "ft3_sc_ks_off": ("tensor3", "scale", "ks_inner"),
        "ksfull": ("fwd_tensor3", "scale_convert", "ks_full"),
    }[gate]
    for device_type in ("cpu", "cuda"):
        assert (ops.multiply_route(ctx.n, 2, 2, device_type),
                ops.scale_convert_route(device_type),
                ops.keyswitch_route(device_type)) == want_routes
    _build.reset_launches()
    prod = ops.multiply_relin(ctx, ct, ct, rlk)
    np.testing.assert_array_equal(prod.numpy(), golden["mul_relin"])
    np.testing.assert_array_equal(ops.decrypt(ctx, sk, prod).numpy(),
                                  golden["dec_mul"])
    assert all(v == 0 for v in _build.LAUNCHES.values())

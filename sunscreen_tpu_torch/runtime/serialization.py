"""Serialization with embedded parameters (port of
`sunscreen_tpu/runtime/serialization.py`).

The reference's format: an npz archive with a JSON header, no pickling,
so bytes move between the two packages both ways. Residues are written
in the reference's dtypes, `np.uint32` on the u32 engine and `np.uint64`
on the u64 engine (the port's int64 words as their bit patterns).

Public, relin and Galois keys are NTT-domain arrays, whose layout
depends on the NTT mode of the context that made them; the reference
records no mode, so its keys loaded under another mode decode to noise.
The port writes the reference's fields plus `"ntt_mode"` (which the
reference ignores) and raises `NttModeMismatch` when that mode's domain
is not the loading context's. Bytes without it, the reference's, load
under the loading context's mode, as `keys.from_reference(mode=...)`
takes the caller's word for it. Ciphertexts and private keys are
coefficient-domain and carry no mode.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.bfv import get_context
from sunscreen_tpu_torch.bfv import keys as bkeys
from sunscreen_tpu_torch.bfv.params import BfvParams
from sunscreen_tpu_torch.compiler.compiler import CompiledFheProgram
from sunscreen_tpu_torch.compiler.ir import FheProgram
from sunscreen_tpu_torch.compiler.trace import CallSignature
from sunscreen_tpu_torch.errors import InvalidArgument
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.runtime.runtime import (Ciphertext, PrivateKey,
                                                 PublicKeySet)


def params_to_dict(p: BfvParams) -> dict:
    return {
        "poly_degree": p.poly_degree,
        "plain_modulus": p.plain_modulus,
        "coeff_modulus": list(p.coeff_modulus),
        "special_modulus": p.special_modulus,
        "security_level": p.security_level,
        "scheme": "bfv",
    }


def params_from_dict(d: dict) -> BfvParams:
    assert d.get("scheme", "bfv") == "bfv"
    return BfvParams(d["poly_degree"], d["plain_modulus"],
                     tuple(d["coeff_modulus"]), d["special_modulus"],
                     d["security_level"])


def _pack(meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(
        buf, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def _unpack(data: bytes) -> tuple[dict, dict]:
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def _host(x: torch.Tensor, params: BfvParams) -> np.ndarray:
    """Residues in the reference's dtype for `params`' engine."""
    a = x.cpu().numpy()
    if m.word_dtype_for(params.coeff_modulus) == m.U32:
        return a.astype(np.uint32)
    return a.view(np.uint64)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """Residues of either engine's dtype -> int64 on `device`."""
    a = a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class ParamsMismatch(Exception):
    """Deserialized object's params differ from the target runtime's."""


class NttModeMismatch(InvalidArgument):
    """Serialized NTT-domain keys whose recorded NTT mode does not give
    the loading context's NTT domain."""


def check_params(meta: dict, expect: BfvParams | None):
    got = params_from_dict(meta["params"])
    if expect is not None and got != expect:
        raise ParamsMismatch(f"expected {expect}, got {got}")
    return got


# -- ciphertexts -------------------------------------------------------------

def ciphertext_to_bytes(ct: Ciphertext) -> bytes:
    meta = {"kind": "ciphertext", "type_name": ct.type_name,
            "params": params_to_dict(ct.params),
            "n": len(ct.cts)}
    arrays = {f"ct{i}": _host(c, ct.params) for i, c in enumerate(ct.cts)}
    return _pack(meta, arrays)


def ciphertext_from_bytes(data: bytes,
                          expect_params: BfvParams | None = None,
                          device=None) -> Ciphertext:
    """`device` None means CUDA."""
    meta, arrays = _unpack(data)
    assert meta["kind"] == "ciphertext"
    params = check_params(meta, expect_params)
    dev = resolve_device(device)
    cts = [_tensor(arrays[f"ct{i}"], dev) for i in range(meta["n"])]
    return Ciphertext(meta["type_name"], cts, params)


# -- keys --------------------------------------------------------------------

def public_keys_to_bytes(pks: PublicKeySet, params: BfvParams) -> bytes:
    meta = {"kind": "public_keys", "params": params_to_dict(params),
            "has_relin": pks.relin_key is not None,
            "galois_elements": sorted(pks.galois_keys.keys)
            if pks.galois_keys else []}
    if pks.ntt_mode is not None:
        meta["ntt_mode"] = pks.ntt_mode
    arrays = {"p0": _host(pks.public_key.p0, params),
              "p1": _host(pks.public_key.p1, params)}
    if pks.relin_key is not None:
        arrays["rlk0"] = _host(pks.relin_key.k0, params)
        arrays["rlk1"] = _host(pks.relin_key.k1, params)
    if pks.galois_keys:
        for g, kk in pks.galois_keys.keys.items():
            arrays[f"gk{g}_0"] = _host(kk.k0, params)
            arrays[f"gk{g}_1"] = _host(kk.k1, params)
    return _pack(meta, arrays)


def public_keys_from_bytes(data: bytes,
                           expect_params: BfvParams | None = None,
                           device=None) -> tuple[PublicKeySet, BfvParams]:
    """Keys on the context `get_context(params, device)` (`device` None
    means CUDA). Raises `NttModeMismatch` when the bytes record an NTT
    mode whose domain is not that context's."""
    meta, arrays = _unpack(data)
    assert meta["kind"] == "public_keys"
    params = check_params(meta, expect_params)
    ctx = get_context(params, device)
    written = meta.get("ntt_mode")
    why = written and bkeys.domain_mismatch(ctx, written)
    if why:
        raise NttModeMismatch(why)
    dev = ctx.device
    pk = bkeys.PublicKey(_tensor(arrays["p0"], dev),
                         _tensor(arrays["p1"], dev))
    rlk = None
    if meta["has_relin"]:
        rlk = bkeys.KswKey(_tensor(arrays["rlk0"], dev),
                           _tensor(arrays["rlk1"], dev))
    gks = None
    if meta["galois_elements"]:
        gks = bkeys.GaloisKeys({
            g: bkeys.KswKey(_tensor(arrays[f"gk{g}_0"], dev),
                            _tensor(arrays[f"gk{g}_1"], dev))
            for g in meta["galois_elements"]})
    return PublicKeySet(pk, rlk, gks, ctx.requested_mode), params


def private_key_to_bytes(priv: PrivateKey, params: BfvParams) -> bytes:
    meta = {"kind": "private_key", "params": params_to_dict(params)}
    return _pack(meta, {"s": priv.sk.s.cpu().numpy()})


def private_key_from_bytes(data: bytes,
                           expect_params: BfvParams | None = None,
                           device=None) -> tuple[PrivateKey, BfvParams]:
    """The secret key's NTT images are computed on the context
    `get_context(params, device)`."""
    meta, arrays = _unpack(data)
    assert meta["kind"] == "private_key"
    params = check_params(meta, expect_params)
    sk, _, _ = bkeys.from_reference(get_context(params, device),
                                    s=arrays["s"])
    return PrivateKey(sk), params


# -- compiled programs -------------------------------------------------------

def program_to_bytes(prog: CompiledFheProgram) -> bytes:
    meta = {"kind": "fhe_program", "name": prog.name,
            "params": params_to_dict(prog.params),
            "ir": json.loads(prog.prog.to_json()),
            "signature": {
                "arg_types": prog.signature.arg_types,
                "ret_types": prog.signature.ret_types,
                "num_ciphertexts": prog.signature.num_ciphertexts,
            }}
    arrays = {f"lit{i}": lit for i, lit in enumerate(prog.literals)}
    return _pack(meta, arrays)


def program_from_bytes(data: bytes) -> CompiledFheProgram:
    meta, arrays = _unpack(data)
    assert meta["kind"] == "fhe_program"
    params = params_from_dict(meta["params"])
    ir = FheProgram.from_json(json.dumps(meta["ir"]))
    sig = meta["signature"]
    signature = CallSignature(
        [tuple(x) for x in sig["arg_types"]],
        [tuple(x) for x in sig["ret_types"]],
        list(sig["num_ciphertexts"]))
    lits = [arrays[f"lit{i}"] for i in range(len(arrays))]
    return CompiledFheProgram(meta["name"], ir, signature, lits, params)

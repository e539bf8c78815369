"""Typed FHE runtime: keygen / encrypt / run / decrypt (port of
`sunscreen_tpu/runtime/runtime.py`).

`Runtime.new_fhe(params, device=None)` runs on CUDA unless the caller
passes `device="cpu"`, and raises when no card is visible. Where the
reference jits each flow, the port calls its BFV ops directly: `run`
walks the lowered program (`compiler/lower.py`), whose ops launch the
CUDA kernels on a CUDA context. Keys and encryptions draw from
`sampling.key_from_seed(seed)`: 128 bits of OS entropy by default.

`Runtime.new_zkp(backend=None, device=None)` proves and verifies with the
Bulletproofs backend (`zk/backend.py`); on CUDA, the default, every
multiexp of at least 2048 points runs the CUDA Pippenger (`zk/cuda_curve.py`)
and the rest the host C++ (`zk/native.py`), which must build there
(`NativeBuildError` otherwise); on `device="cpu"` they run as in the
reference off the TPU. `Runtime.new_fhe_zkp` joins both runtimes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from sunscreen_tpu_torch import observability as obs
from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.bfv import get_context
from sunscreen_tpu_torch.bfv import keys as bkeys
from sunscreen_tpu_torch.bfv import ops as bops
from sunscreen_tpu_torch.bfv.params import BfvParams
from sunscreen_tpu_torch.compiler.compiler import CompiledFheProgram
from sunscreen_tpu_torch.compiler.lower import lower_program
from sunscreen_tpu_torch.math import sampling
from sunscreen_tpu_torch.runtime.builders import (ProofBuilder,
                                                  VerificationBuilder)
from sunscreen_tpu_torch.types.bfv_types import BfvType, resolve_type
from sunscreen_tpu_torch.zk import native
from sunscreen_tpu_torch.zk.backend import BulletproofsBackend

_U64 = (1 << 64) - 1


class RuntimeError_(Exception):
    """Typed runtime failure (reference: `sunscreen_runtime/src/error.rs`)."""


class TooMuchNoise(RuntimeError_):
    """Noise budget exhausted: decryption would be wrong (reference:
    `runtime.rs:182-187`)."""


def _ksw_to(k: bkeys.KswKey, device) -> bkeys.KswKey:
    return bkeys.KswKey(k.k0.to(device), k.k1.to(device))


@dataclass
class Ciphertext:
    """Typed ciphertext: one or more BFV ciphertexts, int64
    [n_comp, k, N] each, and a type tag (reference: `src/lib.rs:161-210`)."""

    type_name: str
    cts: list
    params: BfvParams

    def to(self, device) -> "Ciphertext":
        return replace(self, cts=[c.to(device) for c in self.cts])


@dataclass
class PublicKeySet:
    """Public key plus optional relin and Galois keys (reference:
    `src/keys.rs:25-53`), and the NTT mode of their context where known
    (`runtime/serialization.py` records it)."""

    public_key: bkeys.PublicKey
    relin_key: bkeys.KswKey | None = None
    galois_keys: bkeys.GaloisKeys | None = None
    ntt_mode: str | None = None

    def to(self, device) -> "PublicKeySet":
        pk = self.public_key
        return replace(
            self, public_key=bkeys.PublicKey(pk.p0.to(device),
                                             pk.p1.to(device)),
            relin_key=(None if self.relin_key is None
                       else _ksw_to(self.relin_key, device)),
            galois_keys=(None if self.galois_keys is None
                         else bkeys.GaloisKeys({
                             g: _ksw_to(k, device)
                             for g, k in self.galois_keys.keys.items()})))


@dataclass
class PrivateKey:
    sk: bkeys.SecretKey


def _budget_from_words(hi: int, lo: int) -> float:
    """floor(-log2(2 d)) of the 2^-128-scaled distance (hi, lo), given as
    u64 bit patterns."""
    dist = (float(hi & _U64) * 2.0**-64 + float(lo & _U64) * 2.0**-128)
    dist = max(dist, 2.0**-127)
    return float(np.floor(-np.log2(2.0 * dist)))


class FheRuntime:
    """`Runtime::new_fhe` (reference: `runtime.rs:829-917`) on `device`
    (None means CUDA)."""

    def __init__(self, params: BfvParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.ctx = get_context(params, self.device)
        # id(program) -> (program, lowered callable): the literals are
        # uploaded once per program, the keys are passed on every run
        self._lowered: dict[int, tuple[CompiledFheProgram, object]] = {}

    # -- keys ----------------------------------------------------------------

    def generate_keys(self, seed: int | None = None, galois: bool = True,
                      relin: bool = True
                      ) -> tuple[PublicKeySet, PrivateKey]:
        """Secret, public, relin and Galois keys. seed=None (the default)
        draws 128 bits of OS entropy (`sampling.fresh_key`); an integer
        seed is a deterministic TEST-ONLY mode."""
        ctx = self.ctx
        rng = sampling.key_from_seed(seed)
        sk = bkeys.gen_secret_key(ctx, rng)
        pk = bkeys.gen_public_key(ctx, sk, rng)
        rlk = bkeys.gen_relin_key(ctx, sk, rng) if relin else None
        gks = bkeys.gen_galois_keys(
            ctx, sk, rng, bkeys.default_rotation_elements(ctx)) \
            if galois else None
        return (PublicKeySet(pk, rlk, gks, ctx.requested_mode),
                PrivateKey(sk))

    # -- encrypt / decrypt ---------------------------------------------------

    def _encode(self, tcls, value) -> torch.Tensor:
        polys = tcls.encode(value, self.params, self.device)
        return torch.as_tensor(polys.astype(np.int64), device=self.device
                               ).reshape(-1, polys.shape[-1])

    def encrypt(self, value: BfvType, public_key: PublicKeySet,
                seed: int | None = None) -> Ciphertext:
        """One ciphertext per plaintext polynomial of the encoding, all
        encrypted in one call."""
        tcls = type(value)
        polys = self._encode(tcls, value.value)
        cts = bops.encrypt(self.ctx, public_key.public_key, polys,
                           sampling.key_from_seed(seed))
        return Ciphertext(tcls._type_name(), list(cts), self.params)

    def _decrypt_raw(self, raws: list, private_key: PrivateKey
                     ) -> tuple[np.ndarray, list]:
        """Plaintexts [R, N] and budgets of same-shape raw ciphertexts,
        from one decryption call and one copy to the host."""
        msg, (hi, lo) = bops.decrypt_with_noise(self.ctx, private_key.sk,
                                                torch.stack(raws))
        host = torch.cat([msg, hi.unsqueeze(-1), lo.unsqueeze(-1)],
                         dim=-1).cpu().numpy()
        budgets = [_budget_from_words(int(h), int(lo_))
                   for h, lo_ in host[:, -2:].tolist()]
        return host[:, :-2], budgets

    def _decode(self, type_name: str, polys: np.ndarray):
        return resolve_type(type_name).decode(
            polys if polys.shape[0] > 1 else polys[0], self.params,
            self.device)

    def decrypt(self, ct: Ciphertext, private_key: PrivateKey):
        polys, budgets = self._decrypt_raw(ct.cts, private_key)
        if min(budgets) <= 0:
            raise TooMuchNoise("ciphertext noise budget exhausted")
        return self._decode(ct.type_name, polys)

    def decrypt_many(self, cts: list, private_key: PrivateKey) -> list:
        """Decrypt several ciphertexts with one decryption call over all
        their components and one copy to the host; per ciphertext when
        the components' shapes differ."""
        raws = [c for ct in cts for c in ct.cts]
        if not raws:
            return []
        if any(r.shape != raws[0].shape for r in raws):
            return [self.decrypt(ct, private_key) for ct in cts]
        polys, budgets = self._decrypt_raw(raws, private_key)
        if min(budgets) <= 0:
            raise TooMuchNoise("ciphertext noise budget exhausted")
        out = []
        i = 0
        for ct in cts:
            n = len(ct.cts)
            out.append(self._decode(ct.type_name, polys[i:i + n]))
            i += n
        return out

    def measure_noise_budget(self, ct: Ciphertext,
                             private_key: PrivateKey) -> float:
        budget = min(self._decrypt_raw(ct.cts, private_key)[1])
        obs.metrics.gauge_min("runtime.noise_budget_floor_bits", budget)
        return budget

    # -- run -----------------------------------------------------------------

    def _get_lowered(self, prog: CompiledFheProgram):
        entry = self._lowered.get(id(prog))
        if entry is None or entry[0] is not prog:
            entry = (prog, lower_program(prog, self.ctx))
            self._lowered[id(prog)] = entry
        return entry[1]

    def run(self, prog: CompiledFheProgram, args: list,
            public_key: PublicKeySet) -> list[Ciphertext]:
        """Checks the arguments against the signature, then runs the
        lowered program under `public_key`'s evaluation keys (reference:
        `runtime.rs:310-416`)."""
        with obs.span("runtime.run"):
            obs.metrics.incr("runtime.programs_run")
            obs.metrics.incr(f"runtime.run.{prog.name}")
            if len(args) != len(prog.signature.arg_types):
                raise RuntimeError_(
                    f"program {prog.name!r} expects "
                    f"{len(prog.signature.arg_types)} args, got {len(args)}")
            flat = []
            for a, (tname, is_cipher) in zip(args, prog.signature.arg_types):
                if tname.startswith("[") and tname.endswith("]"):
                    # fixed-size array input "[Cipher<T>; n]": a list of n
                    # ciphertexts (reference: sunscreen/tests/array.rs)
                    inner_t, count = tname[1:-1].rsplit("; ", 1)
                    if not isinstance(a, (list, tuple)) \
                            or len(a) != int(count):
                        raise RuntimeError_(
                            f"argument expects a list of {count} values "
                            f"({tname})")
                    for el in a:
                        if not isinstance(el, Ciphertext):
                            raise RuntimeError_(
                                f"array elements must be Ciphertext "
                                f"({inner_t})")
                        flat.extend(el.cts)
                    continue
                if is_cipher:
                    if not isinstance(a, Ciphertext):
                        raise RuntimeError_(f"expected Ciphertext, got "
                                            f"{type(a).__name__}")
                    inner = tname[len("Cipher<"):-1] \
                        if tname.startswith("Cipher<") else tname
                    if a.type_name != inner:
                        raise RuntimeError_(
                            f"argument type mismatch: expected {tname}, got "
                            f"{a.type_name}")
                    flat.extend(a.cts)
                else:
                    flat.extend(self._encode(
                        resolve_type(tname),
                        a.value if isinstance(a, BfvType) else a))
            rlk = public_key.relin_key
            gks = public_key.galois_keys
            if prog.requires_relin_keys and rlk is None:
                raise RuntimeError_(
                    f"program {prog.name!r} requires relin keys")
            if prog.requires_galois_keys and gks is None:
                raise RuntimeError_(
                    f"program {prog.name!r} requires galois keys")
            outs = self._get_lowered(prog)(*flat, rlk=rlk, gks=gks)
            results = []
            i = 0
            for (tname, _), n_ct in zip(prog.signature.ret_types,
                                        prog.signature.num_ciphertexts):
                results.append(Ciphertext(tname, outs[i:i + n_ct],
                                          self.params))
                i += n_ct
            return results


class ZkpRuntime:
    """ZKP prove/verify runtime on `device` (None means CUDA; reference:
    `GenericRuntime` with the Zkp marker, `runtime.rs:681-769`)."""

    def __init__(self, backend=None, device=None):
        self.backend = backend or BulletproofsBackend()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            native.require_lib()

    def prove(self, program, private_inputs, public_inputs=(),
              constant_inputs=()):
        """A proof of `program` on these inputs. Its blindings come from
        the OS (`secrets`, `r1cs.scalar_source()`)."""
        return self.backend.prove(
            program.build(), [int(x) for x in private_inputs],
            [int(x) for x in public_inputs],
            [int(x) for x in constant_inputs], device=self.device)

    def verify(self, program, proof, public_inputs=(),
               constant_inputs=()) -> bool:
        return self.backend.verify(
            program.build(), proof, [int(x) for x in public_inputs],
            [int(x) for x in constant_inputs], device=self.device)

    def proof_builder(self, program):
        """Fluent proving API (reference: `Runtime::proof_builder`,
        `runtime.rs:728-742`)."""
        return ProofBuilder(self, program)

    def verification_builder(self, program):
        """Fluent verification API (reference:
        `Runtime::verification_builder`, `runtime.rs:815-833`)."""
        return VerificationBuilder(self, program)


class FheZkpRuntime(FheRuntime, ZkpRuntime):
    """Combined runtime (reference: `Runtime::new_fhe_zkp`)."""

    def __init__(self, params: BfvParams, backend=None, device=None):
        FheRuntime.__init__(self, params, device)
        ZkpRuntime.__init__(self, backend, device)


class Runtime:
    """The reference's constructor namespace (`runtime.rs:829-917`)."""

    @staticmethod
    def new_fhe(params: BfvParams, device=None) -> FheRuntime:
        return FheRuntime(params, device)

    @staticmethod
    def new_zkp(backend=None, device=None) -> ZkpRuntime:
        return ZkpRuntime(backend, device)

    @staticmethod
    def new_fhe_zkp(params: BfvParams, backend=None,
                    device=None) -> FheZkpRuntime:
        return FheZkpRuntime(params, backend, device)

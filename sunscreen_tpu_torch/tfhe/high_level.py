"""High-level TFHE API (port of `sunscreen_tpu/tfhe/high_level.py`):
the reference's keygen / encryption / evaluation namespaces over the
ported `ops`, and `UnivariateLookupTable`."""

from __future__ import annotations

from dataclasses import dataclass

from sunscreen_tpu_torch.tfhe import ops
from sunscreen_tpu_torch.tfhe.params import GlweDef, LweDef, \
    RadixDecomposition


class keygen:
    generate_binary_lwe_sk = staticmethod(ops.generate_binary_lwe_sk)
    generate_binary_glwe_sk = staticmethod(ops.generate_binary_glwe_sk)
    generate_uniform_lwe_sk = staticmethod(ops.generate_uniform_lwe_sk)
    generate_uniform_glwe_sk = staticmethod(ops.generate_uniform_glwe_sk)
    generate_bootstrapping_key = staticmethod(ops.generate_bootstrap_key)
    generate_ksk = staticmethod(ops.generate_keyswitch_key)


class encryption:
    encrypt_lwe = staticmethod(ops.encrypt_lwe)
    encrypt_glwe = staticmethod(ops.encrypt_glwe)
    encrypt_ggsw = staticmethod(ops.encrypt_ggsw)
    trivial_lwe = staticmethod(ops.trivial_lwe)
    trivial_glwe = staticmethod(ops.trivial_glwe)
    decrypt_lwe = staticmethod(ops.decrypt_lwe)
    decrypt_lwe_with_carry = staticmethod(ops.decrypt_lwe_with_carry)
    decrypt_glwe = staticmethod(ops.decrypt_glwe)


@dataclass(frozen=True)
class UnivariateLookupTable:
    """A function baked into a PBS test polynomial (reference:
    `UnivariateLookupTable`)."""

    poly: object
    plaintext_bits: int

    @staticmethod
    def trivial_from_fn(fn, glwe: GlweDef, plaintext_bits: int,
                        output_bits: int | None = None, device=None
                        ) -> "UnivariateLookupTable":
        """`output_bits=plaintext_bits-1` reproduces the reference's
        unpadded output encoding (see ops.test_polynomial_for)."""
        return UnivariateLookupTable(
            ops.test_polynomial_for(fn, plaintext_bits, glwe,
                                    output_bits=output_bits, device=device),
            plaintext_bits if output_bits is None else output_bits)


class evaluation:
    cmux = staticmethod(ops.cmux)
    external_product = staticmethod(ops.external_product)
    blind_rotation = staticmethod(ops.blind_rotate)
    sample_extract = staticmethod(ops.sample_extract)
    keyswitch_lwe_to_lwe = staticmethod(ops.keyswitch_lwe_to_lwe)

    @staticmethod
    def univariate_programmable_bootstrap(
            lwe_ct, lut: UnivariateLookupTable, bsk, ksk, lwe: LweDef,
            glwe: GlweDef, pbs_radix: RadixDecomposition,
            ks_radix: RadixDecomposition):
        return ops.programmable_bootstrap_univariate(
            lwe_ct, lut.poly, bsk, ksk, lwe, glwe, pbs_radix, ks_radix)

"""High-level TFHE API (port of `sunscreen_tpu/tfhe/high_level.py`):
the reference's keygen / encryption / evaluation namespaces over the
ported `ops`, and the lookup-table entities `UnivariateLookupTable`
(single and multifunctional) and `BivariateLookupTable`."""

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
    generate_lwe_pk = staticmethod(ops.generate_lwe_public_key)
    generate_bootstrapping_key = staticmethod(ops.generate_bootstrap_key)
    generate_ksk = staticmethod(ops.generate_keyswitch_key)
    generate_cbs_ksk = staticmethod(ops.generate_cbs_pfksk)
    generate_scheme_switch_key = staticmethod(
        ops.generate_scheme_switch_key)
    generate_rlwe_public_key = staticmethod(ops.generate_rlwe_public_key)


class encryption:
    encrypt_lwe = staticmethod(ops.encrypt_lwe)
    encrypt_lwe_and_return_randomness = staticmethod(
        ops.encrypt_lwe_return_components)
    encrypt_glwe = staticmethod(ops.encrypt_glwe)
    encrypt_glwe_public = staticmethod(ops.encrypt_glwe_public)
    encrypt_glev = staticmethod(ops.encrypt_glev)
    encrypt_ggsw = staticmethod(ops.encrypt_ggsw)
    encrypt_binary_msg_rlev = staticmethod(ops.encrypt_rlev_public)
    trivial_lwe = staticmethod(ops.trivial_lwe)
    trivial_glwe = staticmethod(ops.trivial_glwe)
    trivial_binary_glev = staticmethod(ops.trivial_glev)
    decrypt_lwe = staticmethod(ops.decrypt_lwe)
    decrypt_lwe_with_carry = staticmethod(ops.decrypt_lwe_with_carry)
    decrypt_glwe = staticmethod(ops.decrypt_glwe)
    decrypt_glev = staticmethod(ops.decrypt_glev)


@dataclass(frozen=True)
class UnivariateLookupTable:
    """A function baked into a PBS test polynomial (reference:
    `UnivariateLookupTable`). `n_fns > 1` marks a multifunctional table
    (interleaved layout) for
    `evaluation.multifunctional_programmable_bootstrap`."""

    poly: object
    plaintext_bits: int
    n_fns: int = 1

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

    @staticmethod
    def trivial_multifunctional(fns, glwe: GlweDef, plaintext_bits: int,
                                device=None) -> "UnivariateLookupTable":
        """Several functions in one table, all evaluated by one blind
        rotation (reference: `trivivial_multifunctional` [sic])."""
        assert len(fns) > 1
        return UnivariateLookupTable(
            ops.test_polynomial_multi(fns, plaintext_bits, glwe, device),
            plaintext_bits, n_fns=len(fns))


@dataclass(frozen=True)
class BivariateLookupTable:
    """f(a, b) baked into a test polynomial over the packed message
    a 2^carry_bits + b (reference: `BivariateLookupTable`)."""

    poly: object
    plaintext_bits: int
    carry_bits: int

    @staticmethod
    def trivial_from_fn(fn, glwe: GlweDef, plaintext_bits: int,
                        carry_bits: int | None = None, device=None
                        ) -> "BivariateLookupTable":
        if carry_bits is None:
            carry_bits = plaintext_bits
        return BivariateLookupTable(
            ops.bivariate_test_polynomial(fn, plaintext_bits, glwe,
                                          carry_bits, device),
            plaintext_bits, carry_bits)

    def as_univariate(self) -> UnivariateLookupTable:
        """A bivariate table is a univariate table over the packed space."""
        return UnivariateLookupTable(
            self.poly, self.plaintext_bits + self.carry_bits)


class evaluation:
    cmux = staticmethod(ops.cmux)
    glev_cmux = staticmethod(ops.glev_cmux)
    external_product = staticmethod(ops.external_product)
    blind_rotation = staticmethod(ops.blind_rotate)
    sample_extract = staticmethod(ops.sample_extract)
    keyswitch_lwe_to_lwe = staticmethod(ops.keyswitch_lwe_to_lwe)
    circuit_bootstrap = staticmethod(ops.circuit_bootstrap)
    scheme_switch = staticmethod(ops.scheme_switch)

    @staticmethod
    def univariate_programmable_bootstrap(
            lwe_ct, lut: UnivariateLookupTable, bsk, ksk, lwe: LweDef,
            glwe: GlweDef, pbs_radix: RadixDecomposition,
            ks_radix: RadixDecomposition):
        return ops.programmable_bootstrap_univariate(
            lwe_ct, lut.poly, bsk, ksk, lwe, glwe, pbs_radix, ks_radix)

    @staticmethod
    def multifunctional_programmable_bootstrap(
            lwe_ct, lut: UnivariateLookupTable, bsk, ksk, lwe: LweDef,
            glwe: GlweDef, pbs_radix: RadixDecomposition,
            ks_radix: RadixDecomposition):
        """[..., n_fns, n+1]: row j encrypts the table's function j of m,
        one blind rotation for all of them."""
        return ops.programmable_bootstrap_multifunctional(
            lwe_ct, lut.poly, lut.n_fns, bsk, ksk, lwe, glwe, pbs_radix,
            ks_radix)

    @staticmethod
    def bivariate_programmable_bootstrap(
            ct_a, ct_b, lut: BivariateLookupTable, bsk, ksk, lwe: LweDef,
            glwe: GlweDef, pbs_radix: RadixDecomposition,
            ks_radix: RadixDecomposition):
        return ops.programmable_bootstrap_bivariate(
            ct_a, ct_b, None, bsk, ksk, lwe, glwe, pbs_radix, ks_radix,
            lut.plaintext_bits, lut.carry_bits, test_poly=lut.poly)

"""What the BFV cells share: the parameters a configuration and a
traffic mix state, the secret key drawn from the seed, the program's keys
and encryptions made under it, and the plain decryptor that judges the
outputs."""

from __future__ import annotations

from portbench import generate
from portbench.reference import bfv as ref


def params(config: dict, traffic: dict):
    """The configuration's modulus chain under the traffic's plain
    modulus, as the program's `BfvParams`."""
    from sunscreen_tpu_torch.bfv import BfvParams
    return BfvParams(config["poly_degree"], traffic["plain_modulus"],
                     tuple(config["coeff_modulus"]),
                     config["special_modulus"], config["security_level"])


def same_chain(p, config: dict) -> None:
    """Raises unless the program's parameters `p` are the configuration's
    modulus chain."""
    got = (p.poly_degree, list(p.coeff_modulus), p.special_modulus)
    want = (config["poly_degree"], config["coeff_modulus"],
            config["special_modulus"])
    if got != want:
        raise ValueError(f"the program runs {got}, not the configuration's "
                         f"{want}")


class Keys:
    """The ternary secret key s, drawn from the seed on the device, and
    the program's public, relinearization and Galois keys made under it
    by the program's own key generation."""

    def __init__(self, ctx, seed: int, galois=(), relin: bool = True):
        import torch
        from sunscreen_tpu_torch.bfv import keys as bkeys
        self.ctx = ctx
        self.s = generate.integers(
            generate.device_generator(seed, "bfv.secret", ctx.device),
            -1, 1, (ctx.n,)).to(torch.int8)
        self.gen = generate.device_generator(seed, "bfv.keys", ctx.device)
        self.sk, _, _ = bkeys.from_reference(ctx, s=self.s.cpu().numpy())
        self.pk = bkeys.gen_public_key(ctx, self.sk, self.gen)
        self.rlk = bkeys.gen_relin_key(ctx, self.sk, self.gen) \
            if relin else None
        self.gks = bkeys.gen_galois_keys(ctx, self.sk, self.gen,
                                         tuple(galois)) if galois else None

    def encrypt(self, pts):
        """Fresh encryptions of plaintexts [..., N] (coefficients in
        [0, t)): [..., 2, k, N]."""
        from sunscreen_tpu_torch.bfv import ops
        lead = pts.shape[:-1]
        flat = ops.encrypt(self.ctx, self.pk, pts.reshape(-1, self.ctx.n),
                           self.gen)
        return flat.reshape(*lead, *flat.shape[-3:])

    def decryptor(self, config: dict, t: int) -> ref.Decryptor:
        """The plain decryptor under s, over the configuration's moduli."""
        return ref.Decryptor(self.s, config["coeff_modulus"], t)

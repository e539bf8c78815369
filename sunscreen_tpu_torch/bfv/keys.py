"""BFV key generation (port of `sunscreen_tpu/bfv/keys.py`): secret,
public, relinearization and Galois keys, stored in the NTT domain, plus
`from_reference` / `galois_from_reference` to carry the JAX package's
key material over.

Keys are sampled from an explicit generator (a `torch.Generator`, or
the runtime's numpy generator, `sampling.key_from_seed`) through the
context's plans. Each NTT mode's domain is the reference's for that mode
("pallas": the flat j2 n1 + j1 order; "pallas_vpu": the [t', s'] order;
"unrolled" and "compact": bit-reversed order; "matmul": natural order),
so `from_reference` is only a dtype and device move from a reference
context of the same mode. It takes that mode and raises
`InvalidArgument` when it does not give the context's NTT domain.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from sunscreen_tpu_torch.bfv.context import BfvContext
from sunscreen_tpu_torch.errors import InvalidArgument
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import ntt, sampling


@dataclass(frozen=True)
class SecretKey:
    s: torch.Tensor            # int8 [N] ternary
    s_ntt_q: torch.Tensor      # [k, N] NTT over Q
    s_ntt_key: torch.Tensor    # [k+1, N] NTT over Q ∪ {p_sp}


@dataclass(frozen=True)
class PublicKey:
    p0: torch.Tensor           # [k, N] NTT domain
    p1: torch.Tensor           # [k, N] NTT domain


@dataclass(frozen=True)
class KswKey:
    """One key-switching key: digit-major [k, k+1, N], NTT domain."""
    k0: torch.Tensor
    k1: torch.Tensor


@dataclass(frozen=True)
class GaloisKeys:
    """One key-switching key per Galois element g."""
    keys: dict[int, KswKey] = field(default_factory=dict)

    def __getitem__(self, g: int) -> KswKey:
        return self.keys[g]

    def __contains__(self, g: int) -> bool:
        return g in self.keys


def _noise_ntt(ctx: BfvContext, gen, base, plan):
    e = sampling.cbd(gen, (ctx.n,), ctx.device)
    return plan.fwd(sampling.signed_to_rns(e, base.q))


def gen_secret_key(ctx: BfvContext, gen: torch.Generator) -> SecretKey:
    s = sampling.ternary(gen, (ctx.n,), ctx.device)
    return SecretKey(
        s, ctx.plan_q.fwd(sampling.signed_to_rns(s, ctx.q_base.q)),
        ctx.plan_key.fwd(sampling.signed_to_rns(s, ctx.key_base.q)))


def gen_public_key(ctx: BfvContext, sk: SecretKey,
                   gen: torch.Generator) -> PublicKey:
    a = sampling.uniform_mod_q(gen, (ctx.n,), ctx.q_base)  # NTT-invariant
    e = _noise_ntt(ctx, gen, ctx.q_base, ctx.plan_q)
    q = ctx.q_base.q
    p0 = m.neg_mod(m.add_mod(ctx.plan_q.pointwise_mul(a, sk.s_ntt_q), e, q),
                   q)
    return PublicKey(p0, a)


def gen_ksw_key(ctx: BfvContext, sk: SecretKey, w_ntt_key,
                gen: torch.Generator) -> KswKey:
    """For each digit i: k0[i] = -(a_i s + e_i) + p_sp D_i w, k1[i] = a_i,
    with w given in NTT form over the key base."""
    kb = ctx.key_base
    q = kb.q
    k0s, k1s = [], []
    for i in range(ctx.k):
        a = sampling.uniform_mod_q(gen, (ctx.n,), kb)
        e = _noise_ntt(ctx, gen, kb, ctx.plan_key)
        body = kb.mul(w_ntt_key, ctx.ksk_factor[i].reshape(-1, 1))
        mask = m.add_mod(ctx.plan_key.pointwise_mul(a, sk.s_ntt_key), e, q)
        k0s.append(m.sub_mod(body, mask, q))
        k1s.append(a)
    return KswKey(torch.stack(k0s), torch.stack(k1s))


def gen_relin_key(ctx: BfvContext, sk: SecretKey,
                  gen: torch.Generator) -> KswKey:
    s2 = ctx.plan_key.pointwise_mul(sk.s_ntt_key, sk.s_ntt_key)
    return gen_ksw_key(ctx, sk, s2, gen)


def gen_galois_keys(ctx: BfvContext, sk: SecretKey, gen: torch.Generator,
                    elements: tuple[int, ...]) -> GaloisKeys:
    """Keys for a(x) -> a(x^g) keyswitching, one per Galois element: each
    switches from s(x^g) back to s."""
    keys = {}
    for g in elements:
        idx, neg = ctx.galois_table(g)
        s_g = sk.s[idx]
        s_g = torch.where(neg, -s_g, s_g)
        w = ctx.plan_key.fwd(sampling.signed_to_rns(s_g, ctx.key_base.q))
        keys[g] = gen_ksw_key(ctx, sk, w, gen)
    return GaloisKeys(keys)


def default_rotation_elements(ctx: BfvContext) -> tuple[int, ...]:
    """Every power-of-two row rotation in both directions plus the
    column swap (SEAL `GaloisTool::get_elts_all`)."""
    half = ctx.n // 2
    elems = {ctx.rotate_columns_element}
    step = 1
    while step < half:
        elems.add(ctx.rotate_rows_element(step))
        elems.add(ctx.rotate_rows_element(-step))
        step *= 2
    return tuple(sorted(elems))


def domain_mismatch(ctx: BfvContext, mode: str) -> str | None:
    """Why NTT-domain arrays made by a context of NTT mode `mode` are
    not in this context's NTT domains once `mode` is degraded for its
    moduli as the reference degrades it, or None when they are."""
    for plan, mods in ((ctx.plan_q, ctx.q_base.moduli),
                       (ctx.plan_key, ctx.key_mods)):
        theirs = ntt.degrade(ctx.n, mods, mode)
        if not ntt.same_domain(theirs, plan.mode):
            return (f"key material from NTT mode {mode!r} ({theirs!r} for "
                    f"these moduli) is not in this context's NTT domain "
                    f"({plan.mode!r}); build the context under that mode")
    return None


def _check_mode(ctx: BfvContext, mode: str | None) -> None:
    """Raises unless `mode`, the NTT mode of the reference context that
    made some NTT-domain arrays, gives this context's NTT domains."""
    if mode is None:
        raise InvalidArgument(
            "NTT-domain key material needs the NTT mode of the reference "
            "context that made it (mode=...)")
    why = domain_mismatch(ctx, mode)
    if why:
        raise InvalidArgument(why)


def from_reference(ctx: BfvContext, *, mode: str | None = None, s=None,
                   s_ntt_q=None, s_ntt_key=None, p0=None, p1=None, k0=None,
                   k1=None):
    """Key material of the JAX package, as numpy arrays, moved into the
    port's dataclasses on `ctx.device`. Returns (SecretKey or None,
    PublicKey or None, KswKey or None) for whichever groups were given;
    a secret key given only as `s` gets its NTT images computed here.
    NTT-domain arrays need `mode`, the reference context's NTT mode
    (its SUNSCREEN_TPU_NTT): a mode whose domain differs from the
    context's raises `InvalidArgument`."""

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a).astype(np.int64),
                               device=ctx.device).to(dtype)

    if any(a is not None for a in (s_ntt_q, s_ntt_key, p0, p1, k0, k1)):
        _check_mode(ctx, mode)
    sk = pk = rlk = None
    if s is not None:
        s_t = dev(s, torch.int8)
        sq = (ctx.plan_q.fwd(sampling.signed_to_rns(s_t, ctx.q_base.q))
              if s_ntt_q is None else dev(s_ntt_q))
        skey = (ctx.plan_key.fwd(sampling.signed_to_rns(s_t, ctx.key_base.q))
                if s_ntt_key is None else dev(s_ntt_key))
        sk = SecretKey(s_t, sq, skey)
    if p0 is not None:
        pk = PublicKey(dev(p0), dev(p1))
    if k0 is not None:
        rlk = KswKey(dev(k0), dev(k1))
    return sk, pk, rlk


def galois_from_reference(ctx: BfvContext, keys,
                          mode: str | None = None) -> GaloisKeys:
    """The reference's Galois keys, {g: (k0, k1)} as numpy arrays, made
    under NTT mode `mode`, moved onto `ctx.device` (`from_reference`'s
    mode check)."""
    _check_mode(ctx, mode)
    return GaloisKeys({
        int(g): KswKey(*(torch.as_tensor(np.asarray(a).astype(np.int64),
                                         device=ctx.device) for a in k))
        for g, k in keys.items()})

"""Noise models (port of `sunscreen_tpu/compiler/noise.py`): the
canonical-embedding-norm analytic predictor, and the measured model with
target-noise ciphertext synthesis.

The analytic half is the reference's arithmetic line for line, so it
gives the same floats. The measured half encrypts, runs the lowered
program on the port's BFV ops and reads the budgets, with keys and
encryptions drawn from `sampling.key_from_seed(seed)`: other random bits
than the reference's `jax.random`, so a measured budget can differ from
the reference's by the noise of one draw (a bit or two).

Noise is tracked as invariant noise |v| where t/Q*c(s) = m + v + a*t;
decryption succeeds iff |v| < 1/2. budget = -log2(2|v|).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from sunscreen_tpu_torch.bfv import get_context, keys, ops
from sunscreen_tpu_torch.compiler.ir import FheProgram, Op
from sunscreen_tpu_torch.compiler.lower import lower_program
from sunscreen_tpu_torch.math import sampling

NOISE_STD_DEV = 3.24  # CBD(21) stddev, see sunscreen_tpu_torch.math.sampling


def noise_to_noise_budget(invariant_noise: float) -> float:
    """budget = -log2(2|v|) (reference: `mod.rs:184`)."""
    if invariant_noise <= 0:
        return float("inf")
    return -math.log2(2.0 * invariant_noise)


def noise_budget_to_noise(budget: float) -> float:
    """|v| = 2^-budget / 2 (reference: `mod.rs:193`)."""
    return 2.0 ** (-budget) / 2.0


class CanonicalEmbeddingNormModel:
    """Canonical-embedding-norm upper bounds per op (reference:
    `canonical_embedding_norm.rs`; encrypt/mul from Iliashenko pp.
    45/48, add from the SEAL 2.3.1 notes, relin empirically zero)."""

    def __init__(self, params):
        assert params.plain_modulus >= 2
        assert len(params.coeff_modulus) >= 1
        self.params = params
        self.q = float(params.q_product)
        self.t = float(params.plain_modulus)
        self.n = float(params.poly_degree)
        self.r_t = float(params.q_product % params.plain_modulus)

    def encrypt(self) -> float:
        t, n, q = self.t, self.n, self.q
        noise = (t * (n * (t - 1.0) / 2.0)
                 + 2.0 * NOISE_STD_DEV * math.sqrt(12.0 * n * n + 9.0 * n))
        return noise / q

    def add_ct_ct(self, v1: float, v2: float) -> float:
        return v1 + v2

    def add_ct_pt(self, v: float) -> float:
        return v + self.r_t * self.n * self.t / self.q

    def mul_ct_ct(self, v1: float, v2: float) -> float:
        t, n, q = self.t, self.n, self.q
        term_0 = t * math.sqrt(3.0 * n + 2.0 * n * n) * (v1 + v2)
        # the reference's 3*v1 + v2 where the cited bound has 3*v1*v2
        term_1 = 3.0 * v1 + v2
        term_2 = (t / q) * math.sqrt(
            3.0 * n + 2.0 * n * n + 4.0 / 3.0 * n * n * n)
        return term_0 + term_1 + term_2

    def mul_ct_pt(self, v: float) -> float:
        return v * self.n * (self.t - 1.0)

    def relinearize(self, v: float) -> float:
        return v

    def rotation(self, v: float) -> float:
        """Hybrid-keyswitch bound: the switched component adds
        |e_ks| <= k * N * B_err * q_max / p_sp before the t/Q scale,
        with B_err = 6 sigma (the JAX package's bound in place of the
        upstream flat 8 bits)."""
        p = self.params
        k = len(p.coeff_modulus)
        q_max = float(max(p.coeff_modulus))
        e_ks = (k * self.n * 6.0 * NOISE_STD_DEV * q_max
                / float(p.special_modulus))
        return v + self.t * e_ks / self.q


def predict_noise(prog: FheProgram, params,
                  input_noise: float | None = None,
                  model: CanonicalEmbeddingNormModel | None = None
                  ) -> float:
    """Worst output invariant-noise BITS (log2 |v|) after evaluating
    `prog` (reference: `predict_noise`, `mod.rs:38-170`). `input_noise`:
    the absolute invariant noise |v| of the ciphertext inputs (chained
    programs); default a fresh encryption's."""
    mdl = model or CanonicalEmbeddingNormModel(params)
    fresh = input_noise if input_noise is not None else mdl.encrypt()
    noise: list[float] = [0.0] * len(prog.nodes)
    for i, node in enumerate(prog.nodes):
        ops_ = node.operands
        if node.op == Op.INPUT_CIPHERTEXT:
            noise[i] = fresh
        elif node.op in (Op.INPUT_PLAINTEXT, Op.LITERAL):
            noise[i] = 0.0
        elif node.op in (Op.ADD, Op.SUB):
            noise[i] = mdl.add_ct_ct(noise[ops_[0]], noise[ops_[1]])
        elif node.op in (Op.ADD_PLAIN, Op.SUB_PLAIN):
            noise[i] = mdl.add_ct_pt(noise[ops_[0]])
        elif node.op == Op.MULTIPLY:
            noise[i] = mdl.mul_ct_ct(noise[ops_[0]], noise[ops_[1]])
        elif node.op == Op.MULTIPLY_PLAIN:
            noise[i] = mdl.mul_ct_pt(noise[ops_[0]])
        elif node.op == Op.NEGATE:
            noise[i] = noise[ops_[0]]
        elif node.op == Op.RELINEARIZE:
            noise[i] = mdl.relinearize(noise[ops_[0]])
        elif node.op in (Op.SHIFT_LEFT, Op.SHIFT_RIGHT, Op.SWAP_ROWS):
            noise[i] = mdl.rotation(noise[ops_[0]])
        elif node.op == Op.OUTPUT_CIPHERTEXT:
            noise[i] = noise[ops_[0]]
        else:
            raise ValueError(node.op)
    outs = [noise[o] for o in prog.outputs] or [fresh]
    worst = max(outs)
    return math.log2(worst) if worst > 0 else -float("inf")


def predicted_budget(prog: FheProgram, params) -> float:
    """Noise budget bits remaining on the worst output."""
    return -(predict_noise(prog, params) + 1.0)


# ---------------------------------------------------------------------------
# measured model (runs the port's BFV ops)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TargetNoiseLevel:
    """Input-noise specification for `MeasuredModel` (reference:
    `TargetNoiseLevel`, measured_model.rs:16-39). budget=None means a
    fresh encryption."""

    budget: float | None = None

    @staticmethod
    def fresh() -> "TargetNoiseLevel":
        return TargetNoiseLevel(None)


def create_ciphertext_with_noise_level(ctx, pk, sk, rlk, target_budget,
                                       rng):
    """A ciphertext of 0 with about `target_budget` bits left, made by
    burning budget: repeated squaring (quadratic), then doubling
    (linear), keeping the last ciphertext still at or above the target
    (reference: `create_ciphertext_with_noise_level`,
    measured_model.rs:57-225)."""
    zero = torch.zeros(ctx.n, dtype=torch.int64, device=ctx.device)
    ct = ops.encrypt(ctx, pk, zero, rng)
    if float(ops.invariant_noise_budget(ctx, sk, ct)) <= target_budget:
        return ct
    ladder = [lambda c: ops.add(ctx, c, c)]
    if rlk is not None:
        ladder.insert(0, lambda c: ops.multiply_relin(ctx, c, c, rlk))
    for burn in ladder:
        while True:
            cand = burn(ct)
            b = float(ops.invariant_noise_budget(ctx, sk, cand))
            if b < target_budget:
                break
            ct = cand
            if b == target_budget:
                return ct
    return ct


class MeasuredModel:
    """Empirical model: encrypt the inputs (fresh or at a target noise
    level), run the lowered program and measure its output budgets
    (reference: `MeasuredModel`, measured_model.rs), on `device` (None
    means CUDA)."""

    def __init__(self, compiled, params, seed: int = 0,
                 input_targets: list | None = None, device=None):
        ctx = get_context(params, device)
        rng = sampling.key_from_seed(seed)
        sk = keys.gen_secret_key(ctx, rng)
        pk = keys.gen_public_key(ctx, sk, rng)
        need_rlk = compiled.requires_relin_keys or any(
            t is not None and t.budget is not None
            for t in (input_targets or []))
        rlk = keys.gen_relin_key(ctx, sk, rng) if need_rlk else None
        gks = None
        if compiled.requires_galois_keys:
            gks = keys.gen_galois_keys(ctx, sk, rng,
                                       keys.default_rotation_elements(ctx))
        n_ct = sum(1 for nd in compiled.nodes
                   if nd.op == Op.INPUT_CIPHERTEXT)
        n_pt = sum(1 for nd in compiled.nodes
                   if nd.op == Op.INPUT_PLAINTEXT)
        zero = torch.zeros(ctx.n, dtype=torch.int64, device=ctx.device)
        targets = input_targets or [TargetNoiseLevel.fresh()] * n_ct
        assert len(targets) >= n_ct
        args = []
        for tgt in targets[:n_ct]:
            if tgt is None or tgt.budget is None:
                args.append(ops.encrypt(ctx, pk, zero, rng))
            else:
                args.append(create_ciphertext_with_noise_level(
                    ctx, pk, sk, rlk, tgt.budget, rng))
        args += [zero] * n_pt
        outs = lower_program(compiled, ctx)(*args, rlk=rlk, gks=gks)
        self.budgets = [float(ops.invariant_noise_budget(ctx, sk, o))
                        for o in outs]

    @property
    def worst_budget(self) -> float:
        return min(self.budgets)

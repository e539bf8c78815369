"""BfvContext: the bases, NTT plans, converters, scalers, Galois and Δ
tables of one parameter set on one device under one NTT mode (port of
`sunscreen_tpu/bfv/context.py`).

The engine word follows the moduli, as in the reference: the u32 engine
when every modulus is below 2^30 (30-bit aux primes), else the u64
engine (56-bit aux primes). The NTT mode is resolved by
`ntt.resolve_mode` when the context is requested and degraded per plan
by `ntt.get_plan`: the u32 engine's default "pallas"
(`pmntt.NttPlanU32`) or "pallas_vpu" (`pntt.PallasNttPlan`); on the u64
engine "pallas" degrades to "matmul" (`mntt.MatmulNttPlan`), and
"unrolled" and "compact" are `ntt.NttPlan` (the CPU default there). The
port caches contexts by (params, device, mode), so a mode set after a
context was built is honoured; the reference caches by params alone
(`sunscreen_tpu/bfv/context.py:165`), so there a later mode changes
nothing.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.bfv.params import BfvParams
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import ntt, primes, prns, rns
from sunscreen_tpu_torch.math.modular import s64

AUX_PRIME_BITS = 56      # u64 engine: the reference's matmul-NTT bound
AUX_PRIME_BITS_U32 = 30  # u32 engine: every modulus < 2^30


def _aux_base_size(params: BfvParams, aux_bits: int) -> int:
    """#aux primes B so that B holds round(t*x/Q) for tensor coefficients:
    need prod(B)/2 > t*N*Q/4 (centered operands)."""
    bound_bits = (params.plain_modulus.bit_length()
                  + params.poly_degree.bit_length()
                  + params.q_product.bit_length() + 2)
    return max(len(params.coeff_modulus) + 1,
               math.ceil(bound_bits / aux_bits))


class BfvContext:
    def __init__(self, params: BfvParams, device, mode: str = "pallas"):
        """`mode` is an NTT mode; each plan degrades it for its moduli."""
        self.params = params
        n, t, q_mods = (params.poly_degree, params.plain_modulus,
                        params.coeff_modulus)
        self.n, self.t, self.k = n, t, len(q_mods)
        mods = q_mods + (params.special_modulus,)

        # --- bases ---------------------------------------------------------
        self.q_base = rns.RnsBase(q_mods, device)
        self.device = self.q_base.device
        self.word = self.q_base.word
        if self.word == m.U32 and params.special_modulus >= 1 << 30:
            raise ValueError("the u32 engine needs the special modulus "
                             "< 2^30 too")
        aux_bits = (AUX_PRIME_BITS_U32 if self.word == m.U32
                    else AUX_PRIME_BITS)
        aux = tuple(primes.gen_ntt_primes(
            aux_bits, _aux_base_size(params, aux_bits), n, skip=mods))
        self.aux_base = rns.RnsBase(aux, device)
        self.mul_base = rns.RnsBase(q_mods + aux, device)    # Q ∪ B
        self.key_mods = mods                                 # Q ∪ {p}
        self.key_base = rns.RnsBase(mods, device)

        # --- NTT plans -------------------------------------------------------
        self.plan_q = ntt.get_plan(n, q_mods, self.device, mode)
        self.plan_mul = ntt.get_plan(n, self.mul_base.moduli, self.device,
                                     mode)
        self.plan_key = ntt.get_plan(n, self.key_mods, self.device, mode)
        # the mode asked for (the plain ring's plan of the encoder and
        # the mod-switched context take it) and the plans' own
        self.requested_mode = mode
        self.mode = self.plan_q.mode

        # --- converters / scalers -------------------------------------------
        self.conv_q_to_aux = rns.BaseConverter(self.q_base, self.aux_base)
        self.conv_aux_to_q = rns.BaseConverter(self.aux_base, self.q_base)
        self.scale_mul_to_aux = rns.ScaleAndRound(
            self.mul_base, self.q_base, self.aux_base, t)
        self.decrypt_scaler = rns.DecryptScaler(self.q_base, t)
        self.mod_down = rns.ModDown(self.q_base, params.special_modulus)
        # drop-last-limb rescale of mod_switch_to_next (B8 on CUDA)
        self.mod_switch_down = (
            rns.ModDown(rns.RnsBase(q_mods[:-1], device), q_mods[-1])
            if self.k >= 2 else None)
        self._fused_ops: dict[str, object] = {}    # see fused_op()

        # --- Δ = round(Q*m/t) tables (see ops.scale_plain) ------------------
        Q = params.q_product
        w = Q // t

        def col(vals):
            return torch.tensor(vals, dtype=torch.int64,
                                device=self.device).reshape(-1, 1)

        self.delta_mod_q = col([w % q for q in q_mods])
        self.delta_mod_q_sh = col([s64(m.shoup_ratio(w % q, q))
                                   for q in q_mods])
        fr = (((Q % t) << 128) + t - 1) // t  # ceil; error positive
        self.delta_frac_hi = col([s64(fr >> 64)])
        self.delta_frac_lo = col([s64(fr)])

        # p_sp * D_i mod each key modulus (D_i: CRT idempotent of q_i in Q)
        P = params.special_modulus
        self.ksk_factor = torch.tensor(
            [[P * self.q_base.punctured[i] * self.q_base.inv_punctured[i]
              % qj for qj in self.key_mods] for i in range(self.k)],
            dtype=torch.int64, device=self.device)           # [k, k+1]

        # --- Galois tables, built per element on first use ---------------
        self._galois_host: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._galois_dev: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def fused_op(self, kind: str):
        """The context's fused op of one kind, built once: "scale_convert"
        (kernel B7: round(t x / Q) from the multiply base into Q),
        "tensor3" (B10, over the multiply base) or "ks_inner" (B11, over
        the key base). The op holds tables only: which route runs is read
        from the environment on every call (`bfv/ops.py`)."""
        if kind not in self._fused_ops:
            build = {
                "scale_convert": lambda: prns.FusedScaleConvert(
                    self.scale_mul_to_aux, self.conv_aux_to_q),
                "tensor3": lambda: prns.FusedTensor3(self.mul_base),
                "ks_inner": lambda: prns.FusedKsInner(self.key_base),
            }[kind]
            self._fused_ops[kind] = build()
        return self._fused_ops[kind]

    # -- Galois -------------------------------------------------------------

    def galois_table_host(self, g: int):
        """(src_index int64 [N], negate bool [N]) numpy tables for
        a(x) -> a(x^g): coefficient j of the result is +-a[src_index[j]]."""
        if g not in self._galois_host:
            n = self.n
            assert g % 2 == 1 and 0 < g < 2 * n
            i = np.arange(n, dtype=np.int64) * pow(g, -1, 2 * n) % (2 * n)
            self._galois_host[g] = (np.where(i < n, i, i - n), i >= n)
        return self._galois_host[g]

    def galois_table(self, g: int):
        """The same tables as device tensors (cached)."""
        if g not in self._galois_dev:
            idx, neg = self.galois_table_host(g)
            self._galois_dev[g] = (
                torch.as_tensor(idx, device=self.device),
                torch.as_tensor(neg, device=self.device))
        return self._galois_dev[g]

    def rotate_rows_element(self, steps: int) -> int:
        """Galois element of a cyclic row rotation by `steps` slots
        (SEAL: `GaloisTool::get_elt_from_step`)."""
        return pow(3, steps % (self.n // 2), 2 * self.n)

    @property
    def rotate_columns_element(self) -> int:
        return 2 * self.n - 1


@lru_cache(maxsize=16)
def _context_cached(params: BfvParams, device: torch.device,
                    mode: str) -> BfvContext:
    return BfvContext(params, device, mode)


def get_context(params: BfvParams, device=None,
                mode: str | None = None) -> BfvContext:
    """Cached context; `device` None means CUDA, `mode` None means
    `ntt.resolve_mode()` (SUNSCREEN_TPU_NTT, else the device's default
    for these moduli)."""
    dev = resolve_device(device)
    mods = params.coeff_modulus + (params.special_modulus,)
    return _context_cached(params, dev, ntt.resolve_mode(mode, dev, mods))

"""The control and the faults that the correctness check must catch, put
under a run through the harness's own seams (`harness.new_cell`, the
traffic mix, the program's functions).

The control puts the timed path in the nearest precision below the one
the configuration states. BFV states exact arithmetic on residues of up
to 30 bits: the control holds each output residue in a float32 word (24
bits of mantissa), as transforms on the card's float units would. TFHE
states a 64-bit torus: the control hands the program its bootstrap and
keyswitch keys on a 32-bit torus (each word's low 32 bits cleared).

The faults: a step that returns its input unchanged (the cell's op, or
one op of the program); half of each batch left out, its rows copied
from the other half; one answer a batch altered where it is produced
(its message plus one: Delta = floor(Q / t) added to a BFV coefficient,
half the torus to an LWE body).
"""

from portbench import harness

# the op of each cell's traffic that a "state unchanged" fault turns into
# the identity on its first ciphertext argument
UNCHANGED = {
    "bfv_mul_relin": ("sunscreen_tpu_torch.bfv.ops", "multiply_relin",
                      lambda ctx, a, b, rlk: a),
    "bfv_rotsum": ("sunscreen_tpu_torch.bfv.ops", "rotate_rows",
                   lambda ctx, ct, steps, gks: ct),
    "bfv_program": ("sunscreen_tpu_torch.bfv.ops", "multiply_plain",
                    lambda ctx, ct, pt: ct),
    "tfhe_pbs": ("sunscreen_tpu_torch.tfhe.ops",
                 "programmable_bootstrap_univariate",
                 lambda ct, *rest: ct),
}
FAULTS = ("unchanged", "half_batch", "altered")


def _each(out, fn):
    return [fn(t) for t in out] if isinstance(out, list) else fn(out)


def _half(t):
    t = t.clone()
    h = t.shape[0] // 2
    t[h:2 * h] = t[:h]
    return t


def _altered(spec: dict):
    import torch
    config = spec["config"]
    if config["scheme"] == "tfhe":
        def alter(t):
            t = t.clone()
            t[0, -1] += 1 << 63
            return t
        return alter
    qs = config["coeff_modulus"]
    big_q = 1
    for q in qs:
        big_q *= q
    delta = big_q // spec["traffic"]["plain_modulus"]

    def alter(t):
        t = t.clone()
        d = torch.tensor([delta % q for q in qs], device=t.device)
        q = torch.tensor(qs, device=t.device)
        t[0, 0, :, 0] = (t[0, 0, :, 0] + d) % q
        return t
    return alter


def _wrap_outputs(monkeypatch, fn) -> None:
    new_cell = harness.new_cell

    def broken(spec, seed, device):
        cell = new_cell(spec, seed, device)
        batch = cell.batch
        cell.batch = lambda i: _each(batch(i), fn)
        return cell

    monkeypatch.setattr(harness, "new_cell", broken)


def apply_fault(fault: str, spec: dict, monkeypatch) -> None:
    if fault == "unchanged":
        module, name, fn = UNCHANGED[spec["traffic"]["op"]]
        monkeypatch.setattr(f"{module}.{name}", fn)
    elif fault == "half_batch":
        _wrap_outputs(monkeypatch, _half)
    elif fault == "altered":
        _wrap_outputs(monkeypatch, _altered(spec))
    else:
        raise ValueError(fault)


def _torus32(fn, arg: int):
    """fn with its argument `arg` (torus words) cut to a 32-bit torus."""
    def narrow(*args):
        args = list(args)
        args[arg] = args[arg] & ~0xFFFFFFFF
        return fn(*args)
    return narrow


def apply_control(spec: dict, monkeypatch) -> None:
    import torch
    if spec["config"]["scheme"] == "tfhe":
        from sunscreen_tpu_torch.tfhe import ops
        monkeypatch.setattr(ops, "bootstrap_key_to_ntt",
                            _torus32(ops.bootstrap_key_to_ntt, 0))
        monkeypatch.setattr(
            ops, "programmable_bootstrap_univariate",
            _torus32(ops.programmable_bootstrap_univariate, 3))
    else:
        _wrap_outputs(monkeypatch,
                      lambda t: t.to(torch.float32).to(torch.int64))

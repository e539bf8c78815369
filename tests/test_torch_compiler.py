"""The port's compiler, runtime and typed encodings
(sunscreen_tpu_torch.compiler, .runtime, .types) against the JAX package:
traced IR, literals and signatures, the analytic noise model and the
parameter search, the type encodings, `run` bit for bit on the
reference's keys and ciphertexts, two key sets on one program,
serialization both ways, the measured noise model, and the runtime's
decryption and metrics.

The reference builds its keys once per module (one key set serves both
plain moduli: BFV keys depend on Q and the special prime only), at
`insecure_u32(256, limbs=3)` with t = 64 for the Signed programs and its
default batching t for `Batched`, and runs `chi_sq` and the every-op
`Batched` program once each through its jitted `Runtime.run`; the u64
case, at `insecure(128, limbs=2, limb_bits=40)`, runs one jitted
`simple_multiply` on keys and ciphertexts the port serialized. Its
NTT-domain keys are in its CPU default mode; the port runs under its own
("pallas"), so the test carries them over through the two transforms
(`_carry`). The port half runs on `device="cpu"`.
"""

import io
import json

import numpy as np
import pytest
import torch

from sunscreen_tpu import types as rtypes
from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_get_context
from sunscreen_tpu.compiler import Compiler as RefCompiler
from sunscreen_tpu.compiler import PlainModulusConstraint as RefPMC
from sunscreen_tpu.compiler import fhe_program as ref_fhe_program
from sunscreen_tpu.compiler import noise as rnoise
from sunscreen_tpu.compiler import passes as rpasses
from sunscreen_tpu.math.rns import RnsBase as RefRnsBase
from sunscreen_tpu.runtime import Runtime as RefRuntime
from sunscreen_tpu.runtime import serialization as rser
from sunscreen_tpu_torch import observability as obs
from sunscreen_tpu_torch import types
from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys
from sunscreen_tpu_torch.compiler import (Compiler, PlainModulusConstraint,
                                          fhe_program, noise, passes)
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math import ntt, rns
from sunscreen_tpu_torch.runtime import (Ciphertext, PrivateKey,
                                         PublicKeySet, Runtime, TooMuchNoise)
from sunscreen_tpu_torch.runtime import serialization

N = 256
CHI_IN = (2, 7, 9)
CHI_WANT = (529, 242, 275, 1250)   # examples/chi_sq.py expected(2, 7, 9)
LIT = [(7 * i) % 11 - 5 for i in range(N)]
MEASURED_TOL_BITS = 2              # the measured budgets' spread: draws


def programs(fhe_program, T):
    """The test's programs under one package's decorator and types."""
    Cipher, Signed, Batched = T.Cipher, T.Signed, T.Batched

    @fhe_program(scheme="bfv")
    def simple_multiply(a: Cipher[Signed], b: Cipher[Signed]):
        return a * b

    @fhe_program(scheme="bfv")
    def chi_sq(n0: Cipher[Signed], n1: Cipher[Signed], n2: Cipher[Signed]):
        a = 4 * n0 * n2 - n1 * n1
        alpha = a * a
        b1 = 2 * n0 + n1
        b1 = 2 * (b1 * b1)
        b2 = (2 * n0 + n1) * (2 * n2 + n1)
        b3 = 2 * n2 + n1
        b3 = 2 * (b3 * b3)
        return alpha, b1, b2, b3

    @fhe_program(scheme="bfv")
    def chi_sq_optimized(n0: Cipher[Signed], n1: Cipher[Signed],
                         n2: Cipher[Signed]):
        x = n0 + n0 + n1
        y = n2 + n2 + n1
        n0n2 = n0 * n2
        n0n2 = n0n2 + n0n2
        n0n2 = n0n2 + n0n2
        n1sq = n1 * n1
        alpha = n0n2 - n1sq
        alpha = alpha * alpha
        b1 = x * x
        b1 = b1 + b1
        b2 = x * y
        b3 = y * y
        b3 = b3 + b3
        return alpha, b1, b2, b3

    @fhe_program(scheme="bfv")
    def every_op(x: Cipher[Batched], y: Cipher[Batched]):
        p = x * y
        return ((x + y) << 1, (x - y) >> 2, p.swap_rows(), x + LIT,
                y - LIT, x * LIT, -y)

    @fhe_program(scheme="bfv")
    def rational_ops(x: Cipher[T.Rational], y: Cipher[T.Rational]):
        return x / y, x + y, x * y - 1

    @fhe_program(scheme="bfv")
    def fractional_div(x: Cipher[T.Fractional], y: Cipher[T.Fractional]):
        return x / 2.0 + y, x * y - 0.25

    @fhe_program(scheme="bfv")
    def array_in(xs: T.Array[Cipher[Signed], 3]):
        return xs[0] * xs[1] + xs[2]

    @fhe_program(scheme="bfv")
    def two_outputs(a: Cipher[Signed], b: Cipher[Signed]):
        return a + b, 3 - a * b

    fns = (simple_multiply, chi_sq, chi_sq_optimized, every_op,
           rational_ops, fractional_div, array_in, two_outputs)
    return {f.name: f for f in fns}


REF_PROGS = programs(ref_fhe_program, rtypes)
PROGS = programs(fhe_program, types)
P64 = BfvParams.insecure_u32(N, plain_modulus=64, limbs=3)
PB = BfvParams.insecure_u32(N, limbs=3)
PU64 = BfvParams.insecure(128, limbs=2, limb_bits=40)   # the battery's


def _ref_params(p: BfvParams):
    return RefParams(p.poly_degree, p.plain_modulus, p.coeff_modulus,
                     p.special_modulus, p.security_level)


def _params_of(name):
    return PB if name == "every_op" else P64


def _np(x):
    return np.asarray(x).astype(np.int64)


def _carry(a, moduli, mode):
    """A reference NTT-domain array of NTT mode `mode` -> the port's
    "pallas" domain (the inverse transform of that mode, then the
    port's forward)."""
    a = torch.from_numpy(_np(a))
    n = a.shape[-1]
    src = ntt.get_plan(n, moduli, "cpu", mode)
    return ntt.get_plan(n, moduli, "cpu", "pallas").fwd(src.inv(a))


@pytest.fixture(scope="module")
def ref():
    """The reference's keys (Galois keys too), chi_sq's and every_op's
    inputs and outputs through its jitted runtime, their decryptions,
    and the same keys carried into the port's "pallas" domain."""
    r64, rb = _ref_params(P64), _ref_params(PB)
    rt64, rtb = RefRuntime.new_fhe(r64), RefRuntime.new_fhe(rb)
    pub, priv = rtb.generate_keys(seed=1)
    mode = ref_get_context(rb).plan_q.mode
    out = {"pub": pub, "priv": priv, "mode": mode}
    for name, rt, rp, vals in (
            ("chi_sq", rt64, r64, [rtypes.Signed(v) for v in CHI_IN]),
            ("every_op", rtb, rb, [rtypes.Batched(v) for v in (
                np.arange(N) % 97 - 48, (np.arange(N) * 5) % 101 - 50)])):
        prog = (RefCompiler().with_params(rp).fhe_program(REF_PROGS[name])
                .compile().get_program(name))
        args = [rt.encrypt(v, pub, seed=10 + i) for i, v in enumerate(vals)]
        outs = rt.run(prog, args, pub)
        out[name] = {"prog": prog, "args": args, "outs": outs,
                     "values": [v.value for v in vals],
                     "dec": rt.decrypt_many(outs, priv)}

    ctx = get_context(PB, "cpu")
    assert ctx.mode == "pallas"
    q, kq = ctx.q_base.moduli, ctx.key_mods
    sk, _, _ = keys.from_reference(ctx, s=np.asarray(priv.sk.s))
    rl = pub.relin_key
    gks = keys.GaloisKeys({
        g: keys.KswKey(_carry(k.k0, kq, mode), _carry(k.k1, kq, mode))
        for g, k in pub.galois_keys.keys.items()})
    out["port_keys"] = (
        PublicKeySet(keys.PublicKey(_carry(pub.public_key.p0, q, mode),
                                    _carry(pub.public_key.p1, q, mode)),
                     keys.KswKey(_carry(rl.k0, kq, mode),
                                 _carry(rl.k1, kq, mode)),
                     gks, "pallas"),
        PrivateKey(sk))
    return out


def _port_cts(ref_cts, params):
    return [Ciphertext(c.type_name, [torch.from_numpy(_np(x))
                                     for x in c.cts], params)
            for c in ref_cts]


def test_trace_matches_reference():
    """Every program: the same IR JSON, literal pool and signature after
    tracing and the backend passes."""
    for name, pf in PROGS.items():
        params = _params_of(name)
        rprog, rsig, rlits = REF_PROGS[name].build(_ref_params(params))
        prog, sig, lits = pf.build(params, "cpu")
        assert passes.compile_program(prog).to_json() == \
            rpasses.compile_program(rprog).to_json(), name
        assert (sig.arg_types, sig.ret_types, sig.num_ciphertexts) == \
            (rsig.arg_types, rsig.ret_types, rsig.num_ciphertexts), name
        assert len(lits) == len(rlits), name
        for a, b in zip(lits, rlits):
            assert a.dtype == np.uint64
            np.testing.assert_array_equal(a, b)
    ops_used = {n.op for n in passes.compile_program(
        PROGS["every_op"].build(PB, "cpu")[0]).nodes}
    assert {op.value for op in ops_used} == {
        "input_ciphertext", "literal", "add", "sub", "add_plain",
        "sub_plain", "multiply", "multiply_plain", "negate", "relinearize",
        "shift_left", "shift_right", "swap_rows", "output_ciphertext"}


def test_noise_and_search_match_reference(monkeypatch):
    """The same analytic noise floats for every program, the same
    searched params under engine u32, u64 and auto (CPU: u64), and a
    search that moves past a degree whose measured run raises
    Unsupported."""
    for name, pf in PROGS.items():
        params = _params_of(name)
        prog = passes.compile_program(pf.build(params, "cpu")[0])
        rprog = rpasses.compile_program(
            REF_PROGS[name].build(_ref_params(params))[0])
        assert noise.predict_noise(prog, params) == \
            rnoise.predict_noise(rprog, _ref_params(params)), name
        assert Compiler._chained_budget(prog, params, 2) == \
            RefCompiler._chained_budget(rprog, _ref_params(params), 2)
    u32 = BfvParams.default_u32(8192)
    for name in ("simple_multiply", "chi_sq", "chi_sq_optimized"):
        for engine in ("u32", "u64", "auto"):
            c = Compiler("cpu").engine(engine).fhe_program(PROGS[name])
            rc = RefCompiler().engine(engine).fhe_program(REF_PROGS[name])
            if name != "simple_multiply":
                c = c.plain_modulus_constraint(PlainModulusConstraint.Raw(64))
                rc = rc.plain_modulus_constraint(RefPMC.Raw(64))
            got, want = c._search_params(), rc._search_params()
            assert (got.poly_degree, got.plain_modulus, got.coeff_modulus,
                    got.special_modulus, got.security_level) == \
                (want.poly_degree, want.plain_modulus, want.coeff_modulus,
                 want.special_modulus, want.security_level), (name, engine)
            if engine == "u32":
                assert (got.poly_degree, got.coeff_modulus,
                        got.special_modulus) == (8192, u32.coeff_modulus,
                                                 u32.special_modulus)
                assert got.plain_modulus == (
                    u32.plain_modulus if name == "simple_multiply" else 64)

    calls = []

    class Measured:
        def __init__(self, compiled, params, seed=0, input_targets=None,
                     device=None):
            calls.append(params.poly_degree)
            if params.poly_degree == 8192:
                raise Unsupported("no plan at this degree")
            self.worst_budget = 100.0

    monkeypatch.setattr(noise, "MeasuredModel", Measured)
    got = (Compiler("cpu").engine("u32").use_measured_noise_model()
           .fhe_program(PROGS["simple_multiply"])._search_params())
    assert calls == [8192, 16384] and got.poly_degree == 16384


def test_encodings_match_reference():
    """encode arrays equal the reference's and decode(encode(v)) == v for
    every type, at tests/test_types_battery.py's params and boundary
    values; the host CRT of `RnsBase` equals the reference's."""
    rp = _ref_params(PU64)
    mods = PU64.coeff_modulus + (PU64.special_modulus,)
    base = rns.RnsBase(mods, "cpu")
    vals = [0, 1, base.product - 1, base.product // 3, 2**64 + 5]
    res = base.decompose(vals)
    np.testing.assert_array_equal(res, RefRnsBase(mods).decompose(vals))
    assert base.compose(res) == RefRnsBase(mods).compose(res) == vals
    rows = np.arange(128) % 11 - 5
    cases = [
        ("Signed", (0, 1, -1, 2**40, -(2**40), 2**62, -(2**62), 12345,
                    -6789)),
        ("Unsigned64", (0, 5, 2**32, 2**64 - 1)),
        ("Unsigned128", (0, 2**64 + 3, 2**128 - 1)),
        ("Fractional", (3.5, 2.25, -1.75, 0.5, 10.0, -0.125)),
        ("Rational", ((3, 4), (-5, 2))),
        ("Batched", (rows, -rows)),
    ]
    for tname, values in cases:
        ours, theirs = getattr(types, tname), getattr(rtypes, tname)
        for v in values:
            poly = ours.encode(v, PU64, "cpu")
            want = theirs.encode(v, rp)
            assert poly.dtype == np.uint64, tname
            np.testing.assert_array_equal(poly, np.asarray(want))
            back = ours.decode(poly, PU64, "cpu")
            if tname == "Batched":
                np.testing.assert_array_equal(back[:v.size], v)
                np.testing.assert_array_equal(back, theirs.decode(poly, rp))
            else:
                wv = (v[0] / v[1]) if tname == "Rational" else v
                assert back == wv and back == theirs.decode(poly, rp), \
                    (tname, v)


@pytest.mark.parametrize("name", ["chi_sq", "every_op"])
def test_run_matches_reference(ref, name):
    """rt.run on the reference's keys and ciphertexts gives the
    reference's output ciphertexts bit for bit, and their decryptions."""
    params = _params_of(name)
    r = ref[name]
    pub, priv = ref["port_keys"]
    rt = Runtime.new_fhe(params, device="cpu")
    prog = (Compiler("cpu").with_params(params).fhe_program(PROGS[name])
            .compile().get_program(name))
    outs = rt.run(prog, _port_cts(r["args"], params), pub)
    assert len(outs) == len(r["outs"])
    for got, want in zip(outs, r["outs"]):
        assert got.type_name == want.type_name
        for a, b in zip(got.cts, want.cts):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    dec = rt.decrypt_many(outs, priv)
    if name == "chi_sq":
        assert tuple(dec) == tuple(r["dec"]) == CHI_WANT
        return
    t, h = params.plain_modulus, N // 2
    x, y = (np.asarray(v) for v in r["values"])

    def rot(v, k):
        r2 = v.reshape(2, h)
        return np.concatenate([np.roll(r2[0], -k), np.roll(r2[1], -k)])

    lit = np.asarray(LIT)
    wants = [rot(x + y, 1), rot(x - y, -2),
             np.concatenate([(x * y)[h:], (x * y)[:h]]), x + lit, y - lit,
             x * lit, -y]
    for got, theirs, w in zip(dec, r["dec"], wants):
        w = np.mod(w, t)
        np.testing.assert_array_equal(got, np.where(w > t // 2, w - t, w))
        np.testing.assert_array_equal(got, np.asarray(theirs))


def test_two_key_sets_on_one_program(ref):
    """One compiled program under two key sets decrypts correctly under
    each, in either order: the evaluation keys are arguments of each
    run, not bound into the lowered program."""
    rt = Runtime.new_fhe(P64, device="cpu")
    prog = (Compiler("cpu").with_params(P64).fhe_program(PROGS["chi_sq"])
            .compile().get_program("chi_sq"))
    sets = [ref["port_keys"], rt.generate_keys(seed=2, galois=False)]
    for pub, priv in sets + sets[::-1]:
        args = [rt.encrypt(types.Signed(v), pub) for v in CHI_IN]
        assert tuple(rt.decrypt_many(rt.run(prog, args, pub), priv)) == \
            CHI_WANT
    assert len(rt._lowered) == 1


def test_serialization_both_ways(ref, monkeypatch):
    """The reference's bytes (no NTT mode recorded) load in the port
    under the loading context's mode and run to the reference's outputs;
    the port's bytes (the reference's dtypes, u32 and u64) load in the
    reference, which encrypts, runs and decrypts with them; keys whose
    recorded NTT mode does not give the loading context's domain raise
    NttModeMismatch."""
    r = ref["chi_sq"]
    r64 = _ref_params(P64)
    with monkeypatch.context() as mp:
        mp.setenv("SUNSCREEN_TPU_NTT", ref["mode"])
        pub, params = serialization.public_keys_from_bytes(
            rser.public_keys_to_bytes(ref["pub"], r64), device="cpu")
        assert params == P64 and pub.ntt_mode == ref["mode"]
        priv, _ = serialization.private_key_from_bytes(
            rser.private_key_to_bytes(ref["priv"], r64), device="cpu")
        prog = serialization.program_from_bytes(
            rser.program_to_bytes(r["prog"]))
        args = [serialization.ciphertext_from_bytes(
            rser.ciphertext_to_bytes(c), P64, "cpu") for c in r["args"]]
        rt = Runtime.new_fhe(params, device="cpu")
        outs = rt.run(prog, args, pub)
        for got, want in zip(outs, r["outs"]):
            np.testing.assert_array_equal(got.cts[0].numpy(),
                                          _np(want.cts[0]))
        assert tuple(rt.decrypt_many(outs, priv)) == CHI_WANT
    # the port's u32 ciphertexts and program into the reference
    blob = serialization.ciphertext_to_bytes(outs[0])
    assert np.load(io.BytesIO(blob))["ct0"].dtype == np.uint32
    back = [rser.ciphertext_from_bytes(serialization.ciphertext_to_bytes(o))
            for o in outs]
    rt64 = RefRuntime.new_fhe(r64)
    assert tuple(rt64.decrypt_many(back, ref["priv"])) == CHI_WANT
    assert rser.program_from_bytes(
        serialization.program_to_bytes(prog)).prog.to_json() == \
        r["prog"].prog.to_json()
    # the port's u64 keys, ciphertext and program into the reference
    rt = Runtime.new_fhe(PU64, device="cpu")
    pub, priv = rt.generate_keys(seed=3, galois=False)
    pk_b = serialization.public_keys_to_bytes(pub, PU64)
    ct_b = serialization.ciphertext_to_bytes(
        rt.encrypt(types.Signed(7), pub, seed=4))
    with np.load(io.BytesIO(pk_b)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert z["p0"].dtype == z["rlk0"].dtype == np.uint64
    assert meta["ntt_mode"] == "unrolled"
    rpub, rparams = rser.public_keys_from_bytes(pk_b)
    rpriv, _ = rser.private_key_from_bytes(
        serialization.private_key_to_bytes(priv, PU64))
    rrt = RefRuntime.new_fhe(rparams)
    mul = (Compiler("cpu").with_params(PU64)
           .fhe_program(PROGS["simple_multiply"]).compile()
           .get_program("simple_multiply"))
    (prod,) = rrt.run(rser.program_from_bytes(
        serialization.program_to_bytes(mul)),
        [rser.ciphertext_from_bytes(ct_b),
         rrt.encrypt(rtypes.Signed(5), rpub, seed=5)], rpub)
    assert rrt.decrypt(prod, rpriv) == 35
    assert rt.decrypt(serialization.ciphertext_from_bytes(
        rser.ciphertext_to_bytes(prod), PU64, "cpu"), priv) == 35
    # a recorded mode whose domain differs raises; the same mode loads
    pallas_b = serialization.public_keys_to_bytes(ref["port_keys"][0], PB)
    with monkeypatch.context() as mp, pytest.raises(
            serialization.NttModeMismatch, match="NTT"):
        mp.setenv("SUNSCREEN_TPU_NTT", "unrolled")
        serialization.public_keys_from_bytes(pallas_b, device="cpu")
    loaded, _ = serialization.public_keys_from_bytes(pallas_b, device="cpu")
    assert torch.equal(loaded.relin_key.k0, ref["port_keys"][0].relin_key.k0)


def test_measured_model_near_reference():
    """MeasuredModel.worst_budget of simple_multiply within
    MEASURED_TOL_BITS of the reference's: the same program and params,
    other random draws."""
    pf, rpf = PROGS["simple_multiply"], REF_PROGS["simple_multiply"]
    r64 = _ref_params(P64)
    prog = Compiler("cpu").with_params(P64).fhe_program(pf).compile()
    rprog = RefCompiler().with_params(r64).fhe_program(rpf).compile()
    got = noise.MeasuredModel(prog.get_program(pf), P64,
                              device="cpu").worst_budget
    want = rnoise.MeasuredModel(rprog.get_program(rpf), r64).worst_budget
    assert abs(got - want) <= MEASURED_TOL_BITS, (got, want)
    assert got >= Compiler._chained_budget(prog.get_program(pf).prog, P64,
                                           1)


def test_decrypt_noise_and_metrics(ref, tmp_path):
    """decrypt_many equals decrypt per ciphertext; a spent budget raises
    TooMuchNoise from both; run and measure_noise_budget feed the
    reference's counters and gauge, `trace` records a span around the
    program's, and the profiler writes a Chrome trace; without a card
    the default device raises."""
    pub, priv = ref["port_keys"]
    rt = Runtime.new_fhe(P64, device="cpu")
    prog = (Compiler("cpu").with_params(P64)
            .fhe_program(PROGS["two_outputs"]).compile()
            .get_program("two_outputs"))
    obs.metrics.reset()
    args = [rt.encrypt(types.Signed(v), pub) for v in (6, -4)]
    obs.start_profiler(str(tmp_path))
    with obs.trace("run"):
        outs = rt.run(prog, args, pub)
    spans = obs.stop_profiler()
    assert (tmp_path / "trace.json").stat().st_size > 0
    outs += rt.run(prog, args[::-1], pub)
    assert rt.decrypt_many(outs, priv) == [rt.decrypt(o, priv)
                                           for o in outs] == [2, 27, 2, 27]
    snap = obs.metrics.snapshot()["counters"]
    assert snap["runtime.programs_run"] == 2
    assert snap["runtime.run.two_outputs"] == 2
    runs = [i for i, s in enumerate(spans) if s.name == "run"]
    assert len(runs) == 1 and spans[runs[0]].parent == -1
    assert [s.name for s in spans if s.parent == runs[0]] == ["runtime.run"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            Runtime.new_fhe(P64)
    budgets = [rt.measure_noise_budget(o, priv) for o in outs]
    assert obs.metrics.gauges["runtime.noise_budget_floor_bits"] == \
        min(budgets) > 0
    gen = torch.Generator().manual_seed(0)
    noisy = Ciphertext("Signed", [torch.randint(
        0, min(P64.coeff_modulus), (2, 3, N), generator=gen)], P64)
    for call in (lambda: rt.decrypt(noisy, priv),
                 lambda: rt.decrypt_many([outs[0], noisy], priv)):
        with pytest.raises(TooMuchNoise):
            call()

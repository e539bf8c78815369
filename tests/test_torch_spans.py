"""The span recorder of `sunscreen_tpu_torch.observability` and the spans
the port opens: the runtime's `runtime.run`, the lowering's `lower.<op>`
per IR node, the BFV ops' `bfv.<op>` and the TFHE bootstrap's
`tfhe.pbs` ⊃ `tfhe.blind_rotate` ⊃ a first `tfhe.br.glue`, then each
`tfhe.br.step` ⊃ kernels, glue. CPU only, tiny sizes; imports nothing of the JAX package."""

import json
import logging
import timeit

import pytest
import torch

from sunscreen_tpu_torch import observability as obs


def _children(log, i: int) -> list[int]:
    return [j for j, s in enumerate(log) if s.parent == i]


def _tree(log) -> list:
    """(name, [children...]) of each root, recursively."""
    def node(i):
        return (log[i].name, [node(j) for j in _children(log, i)])
    return [node(i) for i, s in enumerate(log) if s.parent < 0]


def test_spans_nest_with_parents_and_one_root_id_a_root():
    with obs.record_spans() as log:
        with obs.span("a"):
            with obs.span("b"):
                with obs.span("c"):
                    pass
            with obs.span("d"):
                pass
        with obs.span("e"):
            with pytest.raises(KeyError):
                with obs.span("f"):
                    raise KeyError("goes on through the span")
    assert _tree(log) == [("a", [("b", [("c", [])]), ("d", [])]),
                          ("e", [("f", [])])]
    assert [s.parent for s in log] == [-1, 0, 1, 0, -1, 4]
    assert [s.root for s in log] == [0, 0, 0, 0, 4, 4]
    for s in log:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = log[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert log.counts() == dict.fromkeys("abcdef", 1)
    assert log.dropped == 0


def test_self_time_is_the_duration_less_the_children():
    log = obs.SpanLog([obs.Span("a", 0, 100, -1, 0),
                       obs.Span("b", 10, 40, 0, 0),
                       obs.Span("c", 15, 25, 1, 0),
                       obs.Span("d", 50, 90, 0, 0),
                       obs.Span("e", 200, 230, -1, 4)])
    assert log.self_ns() == [30, 20, 10, 40, 30]
    with obs.record_spans() as rec:
        with obs.span("outer"):
            with obs.span("inner"):
                sum(range(1000))
    outer, inner = rec.self_ns()
    assert outer + inner == rec[0].end_ns - rec[0].start_ns
    assert inner == rec[1].end_ns - rec[1].start_ns


def test_nothing_is_recorded_while_off():
    assert obs.span("a") is obs.span("b")          # the shared no-op span
    with obs.span("a"):
        with obs.span("b"):
            pass
    assert len(obs.take_spans()) == 0
    with obs.record_spans() as log:
        pass
    with obs.span("after"):
        pass
    assert len(log) == 0 and log.dropped == 0
    obs.start_spans()
    with pytest.raises(RuntimeError, match="already on"):
        obs.start_spans()
    with obs.span("kept"):
        pass
    assert [s.name for s in obs.take_spans()] == ["kept"]


def test_the_cap_keeps_the_first_spans_and_counts_the_rest():
    with obs.record_spans(cap=3) as log:
        with obs.span("a"):
            with obs.span("b"):
                pass
            with obs.span("c"):
                with obs.span("dropped"):
                    pass
            with obs.span("dropped"):
                pass
        with obs.span("dropped"):
            pass
    assert [(s.name, s.parent) for s in log] == [("a", -1), ("b", 0),
                                                  ("c", 0)]
    assert log.dropped == 3
    assert all(s.end_ns >= s.start_ns > 0 for s in log)


def test_the_off_cost_of_a_span():
    """Measured and printed (PERF.md keeps it), not asserted: a shared
    timer is too noisy to bound."""
    n = 100_000
    span = obs.span
    bare = min(timeit.repeat("pass", number=n, repeat=5))
    off = min(timeit.repeat("with span('bfv.add'): pass", number=n,
                            repeat=5, globals={"span": span}))
    with obs.record_spans(cap=n) as log:
        on = timeit.timeit("with span('bfv.add'): pass", number=n,
                           globals={"span": span})
    assert len(log) == n
    print(f"span off {(off - bare) / n * 1e9:.1f} ns, "
          f"on {(on - bare) / n * 1e9:.1f} ns")


def test_trace_is_a_span_that_logs(caplog):
    obs.metrics.reset()
    with caplog.at_level(logging.DEBUG, logger="sunscreen_tpu_torch"):
        with obs.record_spans() as log:
            with obs.trace("unit"):
                with obs.span("inside"):
                    pass
    assert _tree(log) == [("unit", [("inside", [])])]
    assert any(r.getMessage().startswith("unit: ") for r in caplog.records)
    assert obs.metrics.snapshot() == {"counters": {}, "gauges": {}}


def test_the_profilers_trace_holds_the_spans(tmp_path):
    obs.start_profiler(str(tmp_path))
    with obs.span("outer"):
        with obs.trace("inner"):
            torch.ones(4).add_(1)
    log = obs.stop_profiler()
    assert obs.stop_profiler() is None
    assert [(s.name, s.parent) for s in log] == [("outer", -1),
                                                 ("inner", 0)]
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(spans) == {"outer", "inner"}
    marked = [e for e in events if e.get("name") == "inner"
              and e.get("cat") != "span"]
    assert marked, "trace() keeps its record_function"
    out, inner = spans["outer"], spans["inner"]
    assert out["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= out["ts"] + out["dur"] + 1e-3
    # the span lies on the profiler's timeline, within its own range's
    # reach (the anchor's bracket)
    assert abs(inner["ts"] - marked[0]["ts"]) < 1e4
    assert len(obs.take_spans()) == 0               # recording stopped


_BFV_SPAN = {"add": "bfv.add", "sub": "bfv.sub", "add_plain": "bfv.add_plain",
             "sub_plain": "bfv.sub_plain", "multiply": "bfv.multiply",
             "multiply_plain": "bfv.multiply_plain", "negate": "bfv.negate",
             "relinearize": "bfv.relinearize",
             "shift_left": "bfv.rotate_rows", "shift_right": "bfv.rotate_rows",
             "swap_rows": "bfv.rotate_columns"}


def test_a_program_run_is_one_root_with_a_span_a_node():
    from sunscreen_tpu_torch.bfv import BfvParams
    from sunscreen_tpu_torch.compiler import Compiler, fhe_program
    from sunscreen_tpu_torch.runtime import Runtime
    from sunscreen_tpu_torch.types import Batched, Cipher

    lit = [3] * 256

    @fhe_program(scheme="bfv")
    def ops(x: Cipher[Batched], y: Cipher[Batched]):
        return ((x * y) << 1, x - y, x * lit, (-y).swap_rows())

    params = BfvParams.insecure_u32(256, limbs=3)
    prog = (Compiler("cpu").with_params(params).fhe_program(ops).compile()
            .get_program(ops))
    rt = Runtime.new_fhe(params, device="cpu")
    pub, priv = rt.generate_keys(seed=3)
    xs, ys = list(range(256)), [7] * 256
    args = [rt.encrypt(Batched(v), pub) for v in (xs, ys)]
    with obs.record_spans() as log:
        outs = rt.run(prog, args, pub)
    assert [rt.decrypt(o, priv)[:2].tolist() for o in outs] == [
        [1 * 7, 2 * 7], [-7, -6], [0, 3], [-7, -7]]
    roots = [i for i, s in enumerate(log) if s.parent < 0]
    assert [log[i].name for i in roots] == ["runtime.run"]
    nodes = prog.prog.nodes
    lowered = _children(log, roots[0])
    assert [log[i].name for i in lowered] == [
        "lower." + n.op.value for n in nodes]
    for i, node in zip(lowered, nodes):
        want = _BFV_SPAN.get(node.op.value)
        assert [log[j].name for j in _children(log, i)] == (
            [want] if want else [])
    names = log.counts()
    assert names["bfv.keyswitch"] == names["bfv.relinearize"] + \
        names["bfv.apply_galois"] >= 3
    assert names["bfv.permute"] == 2 * names["bfv.apply_galois"]
    assert all(s.root == roots[0] for s in log)


def test_a_bootstrap_is_pbs_over_blind_rotation_over_its_steps():
    from sunscreen_tpu_torch.tfhe import (GlweDef, LweDef,
                                          RadixDecomposition, ops)
    lwe, glwe = LweDef(8, 1e-12), GlweDef(1, 256, 1e-15)
    pbs_radix, ks_radix = RadixDecomposition(3, 4), RadixDecomposition(8, 6)
    gen = torch.Generator().manual_seed(5)
    lwe_sk = ops.generate_binary_lwe_sk(lwe, gen, "cpu")
    glwe_sk = ops.generate_binary_glwe_sk(glwe, gen, "cpu")
    # a bootstrap key of zero-mask GGSWs of the key bits (no GLWE
    # encryption, whose 62-bit plan takes seconds to build): every step
    # runs as under a real key
    raw = torch.zeros(lwe.dim, 2, pbs_radix.count, 2, glwe.poly_degree,
                      dtype=torch.int64)
    for j in range(pbs_radix.count):
        shift = 64 - pbs_radix.radix_log * (j + 1)
        for c in range(2):
            raw[:, c, j, c, 0] = lwe_sk << shift
    bsk = ops.bootstrap_key_to_ntt(raw, glwe, pbs_radix)
    ksk = ops.generate_keyswitch_key(ops.flatten_glwe_sk(glwe_sk), lwe_sk,
                                     lwe, ks_radix, gen)
    tp = ops.test_polynomial_for(lambda m: 1 - m, 2, glwe, output_bits=1,
                                 device="cpu")
    ct = ops.encrypt_lwe(torch.tensor([0, 1 << 62]), lwe_sk, lwe, gen)
    with obs.record_spans() as log:
        out = ops.programmable_bootstrap_univariate(ct, tp, bsk, ksk, lwe,
                                                    glwe, pbs_radix,
                                                    ks_radix)
    assert ops.decrypt_lwe(out, lwe_sk, 1).tolist() == [1, 0]
    ((pbs, parts),) = _tree(log)
    assert pbs == "tfhe.pbs"
    assert [p[0] for p in parts] == ["tfhe.blind_rotate",
                                     "tfhe.sample_extract", "tfhe.keyswitch"]
    first, *steps = parts[0][1]
    assert first == ("tfhe.br.glue", [])
    assert len(steps) == lwe.dim
    for name, children in steps:
        assert name == "tfhe.br.step"
        assert children == [("tfhe.br.kernels", []),
                            ("tfhe.br.glue", [])]

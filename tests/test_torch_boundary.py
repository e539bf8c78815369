"""The port's package boundary: sunscreen_tpu_torch and chip_smoke.py
import neither JAX nor anything of the JAX package, and entry points
called without a device never run on the CPU behind the caller's back."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sunscreen_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_imports_without_jax():
    """Every module of the port and chip_smoke import with `jax`
    unimportable, and leave no module of the JAX package loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and (m == 'sunscreen_tpu'\n"
        "                  or m.startswith(('sunscreen_tpu.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(?:from\s+sunscreen_tpu(?:\.|\s+import\b)"
    r"|import\s+sunscreen_tpu(?:\.|\s|,|$)"
    r"|from\s+jax\b|import\s+jax\b)", re.M)


def test_sources_do_not_import_reference():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _FORBIDDEN.match(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders
    # the pattern itself: the port's own name is allowed
    assert not _FORBIDDEN.match("from sunscreen_tpu_torch.math import rns")
    assert _FORBIDDEN.match("from sunscreen_tpu.math import rns")
    assert _FORBIDDEN.match("from sunscreen_tpu import errors")


def test_entry_points_without_device_need_cuda(monkeypatch):
    """device=None means CUDA; with no card it raises instead of
    quietly running on the CPU."""
    from sunscreen_tpu_torch import resolve_device
    from sunscreen_tpu_torch.bfv import BfvParams, get_context
    from sunscreen_tpu_torch.math import ntt, primes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = BfvParams.insecure_u32(256, limbs=2, limb_bits=25)
    with pytest.raises(RuntimeError, match="no GPU"):
        get_context(params)
    with pytest.raises(RuntimeError, match="no GPU"):
        ntt.get_plan(256, tuple(primes.gen_ntt_primes(29, 2, 256)))
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert get_context(params, "cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_without_gpu(monkeypatch, capsys):
    """No card: chip_smoke exits non-zero before printing any result."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out

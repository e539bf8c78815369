"""Builds the CUDA kernels in `csrc/` with nvcc and binds them with ctypes.

Each `csrc/<name>.cu` becomes `lib<name>.so`, a plain C interface, in
`_kbuild/<digest>/` beside this file (listed in .gitignore). The digest
covers every source, header and flag, so an edit rebuilds. All missing
libraries are compiled at once, one nvcc process per source, and each
one's nvcc output (with ptxas' resource usage) is kept beside it as
`lib<name>.log`. Nothing is built when the package is imported: the
first launch builds.

`LAUNCHES` counts kernel launches per entry point, for every wrapper of
the port (`math/pmntt.py`, `math/prns.py`); the plain twins never count.
Keys name the entry points: "fwd", "fwd_broadcast", "inv" (B1-B3),
"fwd_tensor3" (B4), "inv_ks" (B5), "convert" (B6), "scale_convert" (B7),
"mod_down" (B8), "scale" (B9), "tensor3" (B10), "ks_inner" (B11),
"inv_tensor3" (B12), "fwd_tensor3_full" (B13), "ks_full" (B14),
"ks_full_limbs" (B15), "pntt_fwd" and "pntt_inv" (B16), "pntt_pmul"
(B17), "shoup_mul_mod" and "mul_mod" (B18), "pointwise_mul_mod" (B19),
and "msm" (M1, `zk/cuda_curve.py`: one count a call of its three kernels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_kbuild")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# C entry points per source: "p" = pointer or stream, "i" = int,
# "l" = int64, "u" = uint64.
# Every entry returns its cudaGetLastError() as an int.
SIGNATURES = {
    "ntt": {"ntt_fwd": "ppppiiiip", "ntt_inv": "ppppiiip"},
    "tensor3": {"fwd_tensor3": "ppppiiiip"},
    "inv_ks": {"inv_ks": "ppppppiiiip"},
    "inv_tensor3": {"inv_tensor3": "pppppiiiiip"},
    "rns": {"rns_convert": "pppppiiiiiip", "rns_scale": "pppppiiiip",
            "scale_convert": "pppppppiiiiip", "mod_down": "ppppiiiiiiip"},
    "pointwise": {"tensor3_pointwise": "ppppiiiiip",
                  "ks_inner": "pppppiiiip"},
    "ks_full": {"ks_full": "ppppppiiiiip"},
    "pntt": {"pntt_fwd": "ppppiiip", "pntt_inv": "ppppiiip",
             "pntt_pmul": "pppp" + "i" * 15 + "p"},
    "u64mod": {"u64_shoup_mul_mod": "ppppppiiup",
               "u64_mul_mod": "pppppiiuuup",
               "pointwise_mul_mod": "ppppppluuup"},
    "msm": {"msm": "p" * 10 + "iiii" + "p"},
}

LAUNCHES = dict.fromkeys(
    ("fwd", "fwd_broadcast", "inv", "fwd_tensor3", "inv_ks",
     "convert", "scale_convert", "mod_down",
     "scale", "tensor3", "ks_inner", "inv_tensor3", "fwd_tensor3_full",
     "ks_full", "ks_full_limbs", "pntt_fwd", "pntt_inv", "pntt_pmul",
     "shoup_mul_mod", "mul_mod", "pointwise_mul_mod", "msm"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIBS: dict[str, ctypes.CDLL] = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64,
           "u": ctypes.c_uint64}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build sunscreen_tpu_torch/csrc")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every source not yet built for the current digest,
    concurrently; returns {name: path of the shared library}."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    paths = {s: os.path.join(out_dir, f"lib{s}.so") for s in SIGNATURES}
    todo = [s for s in SIGNATURES if not os.path.exists(paths[s])]
    if todo:
        nvcc = _nvcc()
        procs = {
            s: subprocess.Popen(
                [nvcc, *FLAGS, "-o", paths[s] + ".tmp",
                 os.path.join(CSRC, s + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s in todo}
        errors = []
        for s, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"--- {s}.cu (rc {proc.returncode}) ---\n{log}")
            else:
                with open(paths[s][:-3] + ".log", "w") as f:
                    f.write(log)
                os.replace(paths[s] + ".tmp", paths[s])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for csrc/<name>.cu (ptxas' registers, stack and spills
    of each kernel), building it first if needed."""
    with open(build_all()[name][:-3] + ".log") as f:
        return f.read()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    if name not in _LIBS:
        so = ctypes.CDLL(build_all()[name])
        for fn, sig in SIGNATURES[name].items():
            f = getattr(so, fn)
            f.argtypes = [_CTYPES[c] for c in sig]
            f.restype = ctypes.c_int
        _LIBS[name] = so
    return _LIBS[name]


def launch(name: str, fn: str, *args) -> None:
    """Call a C entry with tensors as pointers and ints as ints, on the
    current CUDA stream; raises on a non-zero CUDA error code."""
    import torch

    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    conv.append(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib(name), fn)(*conv)
    if rc != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA error {rc}")

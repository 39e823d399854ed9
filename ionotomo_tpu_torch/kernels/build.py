"""Build and load the CUDA kernels of ``kernels/csrc`` at first use.

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface for ``sm_90a`` (Hopper), which ``ctypes`` loads. No PyTorch
header is included, so a build takes seconds. The library goes
to ``build/ionotomo_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. ``--use_fast_math`` is deliberately
absent: ``expf``/``sqrtf`` and division must stay IEEE for parity with the
plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ionotomo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library's entry points (restype, argtypes).
_SIGNATURES = {
    "ionotomo_zp_value_grad": (_I, [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                                    _P]),
    "ionotomo_zp_value_grad_batched": (_I, [_P, _I, _P, _P, _I, _I, _I, _P,
                                            _I, _P, _P, _P]),
    "ionotomo_rows_value_fwd": (_I, [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I,
                                     _I, _P, _P, _P]),
    "ionotomo_point_order_keys": (_I, [_P, _I, _I, _P, _I, _I, _I, _I, _I,
                                       _P, _P]),
    "ionotomo_permute_points": (_I, [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P,
                                     _P, _P, _P, _P]),
    "ionotomo_trace_leapfrog_zp": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                        _P, _I, _I, _F, _F, _F, _F, _F, _F,
                                        _I, _P, _P, _P, _P]),
    "ionotomo_pack_zp_taps": (_I, [_P, _I, _I, _P, _P]),
    "ionotomo_rows_value_bwd": (_I, [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P,
                                     _P, _P, _I, _I, _I, _P, _P, _P]),
    "ionotomo_zp_value_grad_bwd": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _I,
                                        _P, _P, _P, _P, _P, _I, _I, _P, _P,
                                        _P]),
    "ionotomo_vector_gather": (_I, [_P, _I, _I, _P, _I, _P, _P]),
    "ionotomo_cubic_value_grad": (_I, [_P, _P, _P, _I, _I, _I, _P, _I, _P,
                                       _P, _P]),
    "ionotomo_cubic_value_grad_bwd": (_I, [_P, _P, _I, _I, _I, _P, _P, _P,
                                           _P, _P, _P, _P, _P, _P, _I, _I,
                                           _P, _P, _P]),
    "ionotomo_trace_leapfrog_cubic": (_I, [_P, _P, _P, _P, _I, _I, _I, _P,
                                           _P, _P, _I, _I, _F, _F, _F, _F,
                                           _F, _F, _I, _P, _P, _P, _P]),
    "ionotomo_pack_z_taps": (_I, [_P, _I, _I, _P, _P]),
    "ionotomo_ray_order_keys": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "ionotomo_rows_value_fwd_batched": (_I, [_P, _I, _I, _I, _P, _P, _I, _P,
                                             _P, _I, _I, _I, _P, _P]),
    "ionotomo_rows_value_bwd_batched": (_I, [_P, _I, _I, _P, _I, _P, _P, _I,
                                             _I, _P, _P, _P, _P, _I, _I, _I,
                                             _P, _P, _P]),
    "ionotomo_fold_member_rows": (_I, [_P, _I, _P, _I, _I, _I, _P, _P]),
    "ionotomo_pack_members": (_I, [_P, _I, ctypes.c_longlong, _P, _P]),
    "ionotomo_zpc_value_grad": (_I, [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                                     _P]),
    "ionotomo_quad_value_grad": (_I, [_P, _P, _P, _I, _I, _I, _P, _I, _P,
                                      _P, _P]),
    "ionotomo_zpc_value_grad_bwd": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                         _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _P, _P, _P]),
    "ionotomo_trace_leapfrog_zpc": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                         _P, _I, _I, _F, _F, _F, _F, _F, _F,
                                         _I, _P, _P, _P, _P]),
    "ionotomo_trace_leapfrog_quad": (_I, [_P, _P, _P, _P, _I, _I, _I, _P,
                                          _P, _P, _I, _I, _F, _F, _F, _F, _F,
                                          _F, _I, _P, _P, _P, _P]),
    **{f"ionotomo_trace_rk4_{m}": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                        _P, _I, _I, _F, _F, _F, _F, _F, _F,
                                        _I, _P, _P, _P, _P])
       for m in ("zp", "cubic", "zpc", "quad")},
    "ionotomo_trace_split": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                                  _I, _I, _F, _F, _F, _F, _F, _P, _I, _F, _I,
                                  _F, _F, _F, _F, _F, _I, _P, _P, _P, _P]),
    "ionotomo_trace_split_layer": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                        _P, _I, _I, _I, _F, _F, _F, _F, _F,
                                        _F, _F, _F, _F, _I, _P, _P, _P, _P]),
    "ionotomo_cubic_sharded_value": (_I, [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _P, _I, _P, _P]),
    "ionotomo_cubic_sharded_value_grad": (_I, [_P, _P, _P, _I, _I, _I, _I,
                                               _I, _P, _I, _P, _P, _P]),
    "ionotomo_cubic_sharded_value_bwd": (_I, [_P, _P, _P, _I, _P, _I, _P,
                                              _P, _P, _P, _I, _I, _I, _P,
                                              _P, _P, _P]),
    "ionotomo_cubic_sharded_value_grad_bwd": (_I, [_P, _P, _P, _I, _P, _I,
                                                   _P, _P, _P, _P, _I, _I,
                                                   _I, _P, _P, _P, _P, _P]),
    "ionotomo_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_loaded = {}


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu"))


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _digest(csrc: Path, defines=()) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        if (home / "bin" / "nvcc").exists():
            nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under CUDA_HOME)")
    return nvcc


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
                 defines=()) -> Path:
    return build_dir / f"libionotomo_kernels_{_digest(csrc, defines)}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR, defines=()) -> dict:
    """Compile the library of the sources in ``csrc`` (the package's own
    by default; ``chip_smoke.py --parent`` builds another checkout's) into
    ``build_dir`` unless this exact build exists. ``defines``: extra
    ``NAME=value`` macros for nvcc (``chip_smoke.py --k5t-study`` builds
    K5ᵀ with other register budgets, ``--member-study`` K3b with other
    scan and fold settings, ``--k2-study`` K2 with scalar row loads,
    ``--e-study`` K1e and K5 with other block sizes and K6z's launch with
    an empty body, ``--k6zt-study`` K6zᵀ as first designed, ``--rk4-study``
    K1r with other register budgets, ``--k1zq-study`` K1z, K1q and K1s).

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` is nvcc's
    output (with ``-Xptxas -v``: registers, shared memory and spills per
    kernel), also kept beside the library.
    """
    lib = library_path(csrc, build_dir, defines)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": lib, "seconds": 0.0, "built": False, "log": log}
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{tag}.tmp.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources(csrc):
        obj = build_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_flags(defines), "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    log_path.write_text(log)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "built": True, "log": log}


def open_library(path, names=None) -> ctypes.CDLL:
    """A built library with the C signatures of its entries ``names``
    (default: all of ``_SIGNATURES``) declared."""
    cdll = ctypes.CDLL(str(path))
    for name in _SIGNATURES if names is None else names:
        fn = getattr(cdll, name)
        fn.restype, fn.argtypes = _SIGNATURES[name]
    return cdll


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed; loaded once per process."""
    if "lib" not in _loaded:
        _loaded["lib"] = open_library(build()["path"])
    return _loaded["lib"]

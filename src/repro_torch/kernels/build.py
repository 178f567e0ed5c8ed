"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this file, and loaded with ``ctypes``.  The library name carries a hash of
the source and flags, so an edited source is rebuilt.  Nothing here runs
when the module is imported: machines without a CUDA toolkit import the
package and use the plain PyTorch lane.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64


class LnsArgs(ctypes.Structure):
    _fields_ = [("qf", _I), ("code_max", _I), ("min_nz", _I),
                ("zero_code", _I), ("delta_kind", _I), ("n_tab", _I),
                ("underflow", _I), ("idx_half", _I), ("idx_lim", _I),
                ("idx_mul", _I), ("idx_shift", _I), ("tab", _P)]


class SgdArgs(ctypes.Structure):
    _fields_ = [("lr_code", _I), ("mom_on", _I), ("mom_code", _I),
                ("wd_on", _I), ("wd_code", _I)]


class MacParams(ctypes.Structure):
    _fields_ = [("lns", LnsArgs),
                ("a_code", _P), ("a_sign", _P), ("a_sr", _I), ("a_st", _I),
                ("b_code", _P), ("b_sign", _P), ("b_st", _I), ("b_sc", _I),
                ("R", _I), ("C", _I), ("CT", _I), ("S", _I),
                ("rows", _I), ("epilogue", _I),
                ("bias_code", _P), ("bias_sign", _P),
                ("llrelu_on", _I), ("beta", _I),
                ("dst_on", _I), ("dst_qf", _I), ("dst_code_max", _I),
                ("dst_min_nz", _I), ("dst_zero", _I), ("z_sign_out", _P),
                ("sgd", SgdArgs),
                ("w_code", _P), ("w_sign", _P), ("m_code", _P),
                ("m_sign", _P), ("m_code_out", _P), ("m_sign_out", _P),
                ("out_code", _P), ("out_sign", _P)]


class UpdateParams(ctypes.Structure):
    _fields_ = [("lns", LnsArgs), ("sgd", SgdArgs), ("n", _I),
                ("w_code", _P), ("w_sign", _P), ("g_code", _P),
                ("g_sign", _P), ("m_code", _P), ("m_sign", _P),
                ("w_code_out", _P), ("w_sign_out", _P),
                ("m_code_out", _P), ("m_sign_out", _P)]


class BoxsumSet(ctypes.Structure):
    _fields_ = [("code", _P), ("sign", _P), ("rows", _I), ("steps", _I),
                ("row_stride", _I), ("step_stride", _I), ("first", _I),
                ("out_code", _P), ("out_sign", _P)]


#: Row sets a ⊞-reduce launch takes (``kMaxGroups`` in ``lns_mac.cu``).
BOXSUM_MAX_SETS = 8


class BoxsumParams(ctypes.Structure):
    _fields_ = [("lns", LnsArgs), ("n_sets", _I), ("max_steps", _I),
                ("sets", BoxsumSet * BOXSUM_MAX_SETS)]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _build(src: Path) -> tuple:
    """Compile ``src`` unless a library of the same source and flags
    exists; returns (library path, ptxas report)."""
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{key}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builds race safely
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The ⊞-MAC / ⊞-SGD / ⊞-reduce library, built on first call."""
    path, _ = _build(CSRC / "lns_mac.cu")
    lib = ctypes.CDLL(str(path))
    for name in ("lns_mac_params_size", "lns_update_params_size",
                 "lns_boxsum_params_size", "lns_boxsum_max_sets",
                 "lns_max_table", "lns_short_steps"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.lns_error_string.argtypes = [ctypes.c_int]
    lib.lns_error_string.restype = ctypes.c_char_p
    lib.lns_mac_launch.argtypes = [ctypes.POINTER(MacParams), _P]
    lib.lns_mac_launch.restype = ctypes.c_int
    lib.lns_update_launch.argtypes = [ctypes.POINTER(UpdateParams), _P]
    lib.lns_update_launch.restype = ctypes.c_int
    lib.lns_boxsum_launch.argtypes = [ctypes.POINTER(BoxsumParams), _P]
    lib.lns_boxsum_launch.restype = ctypes.c_int
    lib.lns_empty_launch.argtypes = [_P]
    lib.lns_empty_launch.restype = ctypes.c_int
    if (lib.lns_mac_params_size() != ctypes.sizeof(MacParams)
            or lib.lns_update_params_size() != ctypes.sizeof(UpdateParams)
            or lib.lns_boxsum_params_size() != ctypes.sizeof(BoxsumParams)
            or lib.lns_boxsum_max_sets() != BOXSUM_MAX_SETS):
        raise RuntimeError("ctypes parameter blocks disagree with "
                           "csrc/lns_mac.cu")
    return lib


def build_report() -> str:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills)."""
    return _build(CSRC / "lns_mac.cu")[1]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.lns_error_string(rc).decode()})")

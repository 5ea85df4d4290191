"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/repro_torch_kernels/
lib<name>-<source hash>.so`` at the root of the checkout, for ``sm_90a``, with
a plain C interface (no PyTorch headers, so a build takes seconds).  The
hash (of the source and the shared ``csrc/*.cuh`` headers) in the file name
makes a changed source rebuild.  :func:`build_all`
starts one ``nvcc`` per source, all together; :func:`load` builds what is
missing and returns the loaded library with every entry point's
``argtypes`` set.  Nothing here runs at import time.

Every entry point returns an ``int``: a launcher returns
``cudaGetLastError()`` and sizes its grid itself (``hash_delta.cu``'s
persistent grid asks the CUDA runtime for the current device's SM count and
the kernel's resident blocks per SM, once per device); ``hash_grid_warps``
returns that grid's warp count, so a check can aim at its edges.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# never --use_fast_math: the quantizer must round exactly as the reference
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "hash_delta": {
        "hash_rows_u32": (_P, _P, _P, _N, _P),
        "hash_rows_u8": (_P, _P, _P, _N, _P),
        "hash_compare_rows_u32": (_P, _P, _P, _P, _P, _P, _N, _P),
        "hash_compare_rows_u8": (_P, _P, _P, _P, _P, _P, _N, _P),
        "hash_fold_rows_u32": (_P, _P, _P, _P, _P, _N, _N, _P),
        "hash_fold_rows_u8": (_P, _P, _P, _P, _P, _N, _N, _P),
        "hash_grid_warps": (_I, _I),
    },
    "quant_blockwise": {
        "quantize_rows_f32": (_P, _P, _P, _N, _P),
        "quantize_rows_bf16": (_P, _P, _P, _N, _P),
        "dequantize_rows_f32": (_P, _P, _P, _N, _P),
        "dequantize_rows_bf16": (_P, _P, _P, _N, _P),
    },
    "flash_attention": {
        "flash_attention_f32": (_P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _I, _P),
        "flash_attention_bf16": (_P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _I, _P),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _N, _N, _N, _N, _N, _I, _P),
        "flash_attention_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _N, _N, _N, _N, _N, _I, _P),
    },
    "ssd_scan": {
        "ssd_scan_f32": (_P, _P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _N, _P),
        "ssd_scan_bf16": (_P, _P, _P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _N, _P),
    },
    "ssd_scan_bwd": {
        "ssd_scan_bwd_f32": (_P,) * 13 + (_N,) * 6 + (_P,),
        "ssd_scan_bwd_bf16": (_P,) * 13 + (_N,) * 6 + (_P,),
    },
    "rg_lru": {
        "rglru_scan_f32": (_P, _P, _P, _P, _N, _N, _N, _P),
        "rglru_scan_bf16": (_P, _P, _P, _P, _N, _N, _N, _P),
        "rglru_scan_bwd_f32": (_P, _P, _P, _P, _P, _P, _N, _N, _N, _P),
    },
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, in parallel.

    Returns ``{name: ptxas report}`` for the libraries built by this call
    (registers and shared memory per kernel).  Raises with the compiler's
    output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    reports, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[n] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if it is missing."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
        return lib


def check_tensor(t, what: str, dtypes, shape) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    one of ``dtypes`` and exactly ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: must be contiguous and 16-byte aligned")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors: such a call
    runs as the kernel's ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code.  The launchers return
    1 (``cudaErrorInvalidValue``) for sizes their kernel does not take."""
    if err == 1:
        raise RuntimeError(f"{what}: the kernel does not take these sizes "
                           f"(cudaErrorInvalidValue at launch)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

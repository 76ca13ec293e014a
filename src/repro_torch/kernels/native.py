"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface, one shared
library per source; the device helpers they share are in ``csrc/*.cuh``.
At first use ``nvcc`` compiles a source into ``build/repro_torch/`` at the
repository root (keyed by a hash of the source, the headers and the flags,
so an edit rebuilds) and the shared library is loaded with ``ctypes``.  No
PyTorch headers enter the build, which keeps it to seconds.  A missing
``nvcc``, a failed build or a failed launch raises: there is no fallback to
the plain versions for CUDA tensors.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the serving path
went through the kernels.  ``VARIANTS`` splits the two flash-prefill kernels'
counts by instantiation: ``/tc`` for bf16 inputs (the tensor-core tile loop of
``csrc/flash_tc.cuh``), ``/fp32`` for float32 inputs (CUDA cores); and counts
the paged-decode launches that fold their split-KV spans themselves
(``paged_decode/fold``, a part of the ``paged_decode`` count).  A CUDA graph
launches its kernels without the wrappers: whoever captures one takes the
counts made while capturing back out (``launch_counts``, ``add_launches``)
and adds them again at every replay.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("paged_attention.cu", "int8_quant.cu", "rmsnorm.cu", "swiglu.cu",
           "flash_prefill.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the card's per-block shared-memory limit (H100: 227 KB usable)
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256
# threads of a block-per-row launch (kThreads of int8_quant.cu, rmsnorm.cu)
ROW_THREADS = 256

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "decode_reduce": 0,
                            "paged_prefill": 0, "quantize_int8": 0,
                            "quantize_int8_shards": 0,
                            "dequant_sum_quantize_int8": 0,
                            "dequantize_int8_gathered": 0,
                            "flash_prefill": 0, "rms_norm": 0, "swiglu": 0}
# launches of B3 and B4 by instantiation (their sum is the LAUNCHES count),
# and of B1 with the split-KV fold inside
VARIANTS: Dict[str, int] = {"paged_prefill/tc": 0, "paged_prefill/fp32": 0,
                            "flash_prefill/tc": 0, "flash_prefill/fp32": 0,
                            "paged_decode/fold": 0}
# nvcc output (register / shared-memory report) of each build, by source
BUILD_LOGS: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points of each source: argument types
_SIGNATURES = {
    "paged_attention.cu": {
        "paged_decode": [_I] + [_P] * 12 + [_I] * 13 + [_F, _P],
        "decode_reduce": [_P] * 6 + [_I] * 5 + [_P],
        "paged_prefill": [_I] + [_P] * 9 + [_I] * 11 + [_F, _P],
        "paged_attention_smem_bytes": [_I, _I, _I],
    },
    "int8_quant.cu": {
        "quantize_int8": [_I] + [_P] * 3 + [_I] * 4 + [_P],
        "quantize_int8_shards": [_I] + [_P] * 3 + [_L] + [_I] * 4 + [_P],
        "dequant_sum_quantize_int8": [_P] * 4 + [_L] + [_I] * 4 + [_P],
        "dequantize_int8_gathered": [_I] + [_P] * 3 + [_L] + [_I] * 3 + [_P],
    },
    "rmsnorm.cu": {
        "rms_norm": [_I, _I] + [_P] * 3 + [_I, _I, _F, _I, _I, _P],
    },
    "swiglu.cu": {
        "swiglu": [_I] + [_P] * 3 + [_L, _I, _P],
    },
    "flash_prefill.cu": {
        "flash_prefill": [_I] + [_P] * 4 + [_I] * 10 + [_F, _P],
    },
}
_RESTYPES = {"paged_attention_smem_bytes": _L}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANTS):
        for k in counts:
            counts[k] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of every launch counter, ``LAUNCHES`` and ``VARIANTS``."""
    return {**LAUNCHES, **VARIANTS}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (counter name -> launches, of ``launch_counts``) to the
    counters."""
    for name, n in delta.items():
        (VARIANTS if "/" in name else LAUNCHES)[name] += n


def count_launch(name: str, dtype: torch.dtype) -> None:
    """Count one launch of B3 or B4 (``name``), and of its instantiation."""
    LAUNCHES[name] += 1
    VARIANTS[f"{name}/{'tc' if dtype == torch.bfloat16 else 'fp32'}"] += 1


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME "
                       "or /usr/local/cuda); the port's CUDA kernels are "
                       "compiled at first use")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` to a shared library (cached by content)."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[source] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, Path]:
    """Compile every source at once, one ``nvcc`` per source in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        futures = {s: ex.submit(build, s) for s in SOURCES}
        return {s: f.result() for s, f in futures.items()}


def library(source: str = "paged_attention.cu") -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, args in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _libs[source] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a C entry."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the kernels take float32 or bfloat16 tensors, got "
                    f"{t.dtype}")


@functools.lru_cache(maxsize=None)
def _smem_need(rows: int, ps: int, hd: int) -> int:
    return library().paged_attention_smem_bytes(rows, ps, hd)


def check_smem(rows: int, ps: int, hd: int, kernel: str) -> None:
    """Limits of the fp32 paged-prefill block (the TPU's (8, 128) tiling does
    not carry over): head_dim <= 256 and its fp32 tiles within shared
    memory.  The library is asked once per (rows, ps, hd)."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {hd} > {MAX_HEAD_DIM}")
    need = _smem_need(rows, ps, hd)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel}: {rows} query rows x page_size {ps} x "
                         f"head_dim {hd} need {need} B of shared memory per "
                         f"block, over the card's {MAX_SMEM_BYTES} B")


def cp_async_ok(hd: int, *tensors: torch.Tensor) -> bool:
    """Whether a kernel may fill its tiles with 16-byte cp.async pieces:
    rows of whole pieces (hd a multiple of 16 bytes' worth of the tensors'
    elements: 8 bf16, 4 fp32) at 16-byte aligned bases."""
    per_piece = 16 // tensors[0].element_size()
    return hd % per_piece == 0 and all(t.data_ptr() % 16 == 0
                                       for t in tensors)


def check_inputs(q, k_pages, v_pages, block_tables, lengths,
                 kernel: str) -> None:
    """Device, dtype, shape and contiguity checks shared by the paged
    kernels' wrappers (the plain versions take the same inputs)."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, q on {dev}")
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(f"{kernel}: k/v pools must share one (N, ps, Hkv, "
                         f"hd) shape, got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{kernel}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype})")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{kernel}: page pools must be contiguous")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{kernel}: {name} must be integer, got {t.dtype}")


def row_launch(x: torch.Tensor, out: torch.Tensor,
               vec_bytes: int = 16) -> Tuple[bool, bool]:
    """``(vec, block_per_row)`` of a row kernel over x (rows, d) into out:
    vectors of ``vec_bytes`` of x where d and both base addresses allow
    them, and a block of ``ROW_THREADS`` per row once a row holds that many
    vectors (a warp per row below that, or on the scalar path)."""
    n_vec = vec_bytes // x.element_size()   # elements per vector load
    vec = x.shape[-1] % n_vec == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    return vec, vec and x.shape[-1] // n_vec >= ROW_THREADS


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

"""Build, load and launch the hand-written CUDA kernels.

The sources under ``repro_torch/csrc`` are compiled at first use with
``nvcc`` into one shared library with a plain C interface, cached under
``build/repro_torch/<hash of sources and flags>/`` at the repository
root, and loaded with ``ctypes``.  Each translation unit compiles in its
own ``nvcc`` process, all started together, before one link step.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`launch` raises on a
non-zero status and counts the launch in :data:`LAUNCHES`, so a run can
show which kernels its main path went through.  A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "repro_clip_quant": (_P, _I, _L, _F, _F, _F, _F, _I, _P, _P, _P, _P, _L,
                         _P, _P),
    "repro_clip_quant_pack": (_P, _I, _L, _F, _F, _F, _I, _I, _P, _P, _P,
                              _L, _P, _P),
    "repro_clip_quant_tiles": (_P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I,
                               _P, _P, _P),
    "repro_clip_quant_tiles_fast": (_P, _I, _L, _I, _I, _P, _P, _I, _I, _P,
                                    _P, _P, _P, _P),
    "repro_encode_tiles": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P,
                           _P, _P),
    "repro_index_histogram": (_P, _L, _I, _P, _P, _L, _P, _P),
    "repro_index_histogram_tiles": (_P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                    _P, _P),
    "repro_rans_step": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    "repro_ecsq_assign": (_P, _I, _L, _F, _F, _P, _P, _I, _P, _P, _P, _P, _L,
                          _P, _P),
    "repro_ecsq_assign_pack": (_P, _I, _L, _F, _F, _P, _P, _I, _I, _P, _P,
                               _P, _L, _P, _P),
    "repro_ecsq_assign_tiles": (_P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                                _P, _I, _P, _P, _P),
    "repro_ecsq_assign_tiles_fast": (_P, _I, _L, _I, _I, _P, _P, _P, _P, _I,
                                     _P, _P, _I, _P),
    "repro_pack_bits": (_P, _L, _I, _P, _P),
    "repro_decode_attention": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _F, _F, _P, _P, _P, _P),
    "repro_prefill_attention": (_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                                _L, _L, _L, _L, _L, _L, _F, _P, _P),
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"clip_quant": 0, "clip_quant_tiles": 0,
                            "encode_tiles": 0, "index_histogram": 0,
                            "index_histogram_tiles": 0, "rans_step": 0,
                            "ecsq_assign": 0, "ecsq_assign_tiles": 0,
                            "pack_bits": 0, "decode_attention": 0,
                            "prefill_attention": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _sources() -> tuple[list[Path], str]:
    units = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return units, h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def _build(out_dir: Path) -> Path:
    nvcc = _nvcc()
    units, _ = _sources()
    work = out_dir / f"work.{os.getpid()}"     # private to this process
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / (u.stem + ".o") for u in units]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(u), "-o", str(o)]
              for u, o in zip(units, objs)])
    tmp = work / LIB_NAME
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    lib = out_dir / LIB_NAME
    os.replace(tmp, lib)                        # atomic publish
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            _, digest = _sources()
            path = BUILD_ROOT / digest / LIB_NAME
            if not path.exists():
                t0 = time.perf_counter()
                path = _build(path.parent)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(kernel: str, symbol: str, *args) -> None:
    """Call C entry point ``symbol`` (stream appended), raise on a bad
    status, and count one launch of ``kernel``.  The count is taken under
    the lock: the transport launches kernels from pool threads, and an
    unguarded read-modify-write of the counter could lose one."""
    fn = getattr(library(), symbol)
    status = fn(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {status}")
    with _lock:
        LAUNCHES[kernel] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of ``t``; ``None`` (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


# The cross-block histogram's scratch (csrc/common.cuh store_histogram):
# at most 64 int32 per block.  The C entries' grids hold at most two
# blocks per SM, or one per _HIST_LEVELS_PER_BLOCK values (256 threads of
# kCountsPerThread), and refuse a smaller buffer.
_HIST_MIN_ROWS = 1024
_HIST_LEVELS_PER_BLOCK = 256 * 2000


def hist_rows(n: int, device) -> torch.Tensor:
    """Uninitialised per-block rows for a histogram of ``n`` values (the
    kernel writes every entry it reads; allocating launches nothing)."""
    rows = max(_HIST_MIN_ROWS, -(-n // _HIST_LEVELS_PER_BLOCK))
    return torch.empty((rows, 64), dtype=torch.int32, device=device)


# (device index, stream handle) -> the stream's ticket word
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def hist_ticket(device) -> torch.Tensor:
    """The zeroed ticket word of the cross-block histogram
    (csrc/common.cuh store_histogram) for the current stream of
    ``device``.  Made and zeroed on that stream the first time it asks,
    then kept: the kernel's last block resets it, so each launch finds
    it at 0, launches on one stream take it in turn and launches on two
    streams never share it.  Later calls launch nothing."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(device).cuda_stream)
    with _lock:
        word = _TICKETS.get(key)
        if word is None:
            word = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                               device=device)
    return word


def check_numel(name: str, t: torch.Tensor) -> None:
    """Kernels that index with 32-bit integers take < 2**31 elements."""
    if t.numel() >= 1 << 31:
        raise ValueError(f"{name} has {t.numel()} elements; this kernel "
                         "takes fewer than 2**31")


def check_cuda(name: str, t: torch.Tensor, dtypes=None, ndim=None) -> None:
    """Validate a kernel argument: CUDA, contiguous, dtype and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")

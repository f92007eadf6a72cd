"""Build the hand-written CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point and includes no PyTorch
header, so `nvcc` turns it into a shared library in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The library lands in `build/kernels/` at the root of the checkout, named by a
hash of its sources and flags, so a changed source builds anew on first use
and an unchanged one is loaded as it is.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FNS: Dict[Tuple[str, str], Callable[..., int]] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else the one on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc")) if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library for csrc/<name>.cu lives, keyed by source hash."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that has no library yet, one nvcc process
    per source, all started together.  Returns the compiler output (ptxas
    registers, shared memory, spills) of each source built now.  Raises if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point `symbol` of csrc/<name>.cu, building the library
    if needed.  Every entry point returns a cudaError_t as int."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "FFMA")  # tensor-core, TMA and SIMT f32 instructions


def parse_sass(text: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function of a `cuobjdump -sass` listing, how many of its
    instructions have each opcode in SASS_OPS (modifiers and predicates
    ignored: `@!P0 HGMMA.64x64x16.F32.BF16 ...` counts as HGMMA)."""
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            current = counts.setdefault(line.split(":", 1)[1].strip(),
                                        dict.fromkeys(SASS_OPS, 0))
        elif current is not None and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".", 1)[0]
                if op in current:
                    current[op] += 1
    return counts


def sass_counts(name: str) -> Dict[str, Dict[str, int]]:
    """`parse_sass` of the built library for csrc/<name>.cu, disassembled by
    the cuobjdump beside nvcc."""
    tool = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(library_path(name))], check=True,
                         capture_output=True, text=True).stdout
    return parse_sass(out)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DtypeCode


def refuse_dtensors(kernel: str, *tensors) -> None:
    """Raise if any input is a DTensor, on any device: a kernel takes one
    rank's own shards (`models.dist.local_heads` and `local_ssd` hand them
    over under a mesh), never the distributed tensor around them."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{kernel}: got a DTensor; under a mesh a kernel takes "
                        f"each rank's own shards (models.dist.local_heads, local_ssd)")


def check_inputs(kernel: str, *args) -> int:
    """Validate tensors for a kernel launch: one CUDA device, contiguous,
    16-byte aligned.  Each argument is a tensor, or a (tensor, dtype) pair
    that declares that tensor's own dtype (e.g. ssd_scan's float32 dt beside
    bfloat16 x).  Every bare tensor shares the first bare tensor's dtype,
    one the kernels take.  Returns that dtype's code."""
    pairs = [a if isinstance(a, tuple) else (a, None) for a in args]
    bare = [t for t, want in pairs if want is None]
    dtype = bare[0].dtype
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{kernel}: dtype {dtype} not supported "
                        f"(float32, bfloat16)")
    device = pairs[0][0].device
    for t, want in pairs:
        want = dtype if want is None else want
        if t.device != device or t.dtype != want:
            raise ValueError(f"{kernel}: input on {t.device}/{t.dtype}, "
                             f"expected {device}/{want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: inputs must be contiguous and "
                             f"16-byte aligned")
    return code

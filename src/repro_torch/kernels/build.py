"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
through :mod:`ctypes`.  Each source compiles to an object in its own
``nvcc`` process, all started together, and the objects are then linked.
The library is built at first use, into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), and is named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("axpy.cu", "matmul.cu", "atax.cu", "covariance.cu",
           "flash_attention.cu", "ssm_scan.cu", "decode_attention.cu",
           "mla_attention.cu")
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
#: the repository root (src/repro_torch/kernels/build.py -> parents[3])
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

#: dtype codes of the C interface (``DtypeCode`` in csrc/common.cuh)
DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
#: argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "repro_axpy": (_I, _P, _P, _P, _D, _L, _P),
    "repro_matmul": (_I, _P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _P),
    "repro_atax": (_I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P),
    "repro_atax_max_clusters": (_I, _I, _I, _I, _I, _I, _I,
                                ctypes.POINTER(_I)),
    "repro_covariance": (_I, _P, _P, _P, _L, _I, _I, _P),
    "repro_flash_attention": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    "repro_ssm_scan": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_flash_qk_tile": (_P, _P, _P, _I, _P),
    "repro_decode_attention": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _D, _P),
    "repro_mla_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _D, _P),
}


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float
    built: bool              # False when an existing library was reused
    ptxas: str = ""          # per-kernel register/shared-memory report


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on a machine with "
        "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def build(*, verbose: bool = False) -> BuildResult:
    """Compile the kernels into ``BUILD_DIR`` (one ``nvcc`` per source, in
    parallel) and link.

    ``verbose=True`` adds ``-Xptxas -v`` (which leaves the code as it is)
    and returns its report; a library that already exists is reused
    without a report.  Raises
    :class:`RuntimeError` with the compiler's output when a step fails.
    """
    import time
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return BuildResult(lib, time.perf_counter() - t0, built=False)
    nvcc = nvcc_path()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs: List[subprocess.Popen] = []
        objs: List[str] = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports: Dict[str, str] = {}
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            reports[src] = out
            if proc.returncode != 0:
                failed.append(f"--- nvcc {src} (rc={proc.returncode}) ---\n{out}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        staged = os.path.join(tmp, lib.name)
        link = subprocess.run([nvcc, "-shared", "-o", staged, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"kernel link failed (rc={link.returncode}):\n"
                f"{link.stdout}{link.stderr}")
        os.replace(staged, lib)
    ptxas = "".join(f"--- {src} ---\n{out}" for src, out in reports.items())
    return BuildResult(lib, time.perf_counter() - t0, built=True, ptxas=ptxas)


#: the SASS opcodes the census counts: wgmma (HGMMA) and mma.sync (HMMA)
#: on bf16, DMMA on fp64, TMA loads (UTMALDG), cp.async (LDGSTS) and
#: cp.async.bulk (UBLKCP)
CENSUS_OPCODES = ("HGMMA", "HMMA", "DMMA", "UTMALDG", "LDGSTS", "UBLKCP")
_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def parse_sass(text: str) -> Dict[str, Dict[str, int]]:
    """Counts of ``CENSUS_OPCODES`` in each function of a
    ``cuobjdump -sass`` listing, by (mangled) function name."""
    census: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        fn = _SASS_FUNCTION.match(line)
        if fn:
            counts = census.setdefault(fn.group(1),
                                       dict.fromkeys(CENSUS_OPCODES, 0))
            continue
        op = _SASS_OPCODE.search(line)
        if counts is not None and op and op.group(1) in counts:
            counts[op.group(1)] += 1
    return census


def sass_census(path: Path) -> Dict[str, Dict[str, int]]:
    """``parse_sass`` of the built library, read with ``cuobjdump -sass``
    (beside ``nvcc``)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed: {out.stderr.strip()}")
    return parse_sass(out.stdout)


def load(path: Path) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return cdll


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once per process)."""
    return load(build().path)


def check_rc(rc: int, kernel: str) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed with CUDA error {rc}")


#: where the kernels' backward pass stands in the plan of work
BACKWARD = ("the kernels have no backward pass yet: ROADMAP.md, 'After the "
            "modules', a backward for the flash and scan kernels")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``.

    A kernel's output is a fresh tensor with no autograd history, so a
    gradient asked through it would be dropped without an error.  Every
    wrapper calls this first, before any device check, so a caller on the
    CPU sees it as well (``None`` entries are skipped)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad under autograd; run the "
            f"kernel under torch.no_grad(), or the plain version for "
            f"training ({BACKWARD})")


def check_inputs(kernel: str, *tensors: torch.Tensor) -> int:
    """Validate what every kernel takes: CUDA, one device, one supported
    dtype, contiguous.  Returns the dtype code.

    One pass that reads each tensor's device index, dtype and layout once;
    the reason for a refusal is worked out only when there is one."""
    first = tensors[0]
    dtype, index = first.dtype, first.get_device()   # -1 on the CPU
    for t in tensors:
        if (t.get_device() != index or t.dtype != dtype
                or not t.is_contiguous()):
            _refuse(kernel, tensors)
    if index < 0:
        _refuse(kernel, tensors)
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(
            f"{kernel} kernel takes {sorted(map(str, DTYPE_CODES))}, "
            f"got {dtype}")
    return code


def _refuse(kernel: str, tensors) -> None:
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel needs CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{kernel}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"{kernel}: dtypes {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel needs contiguous tensors")
    raise AssertionError("unreachable: check_inputs found no fault")


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The C entry point ``name`` of the kernel library (built on first
    use)."""
    return getattr(library(), name)


def launch(kernel: str, name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``t``'s device, with that device current, and raise if the launch was
    refused.  The device is switched only when it is not the current one
    already."""
    fn = entry(name)
    index = t.get_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    check_rc(rc, kernel)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it starts off a 16-byte boundary (TMA
    reads from 16-byte aligned addresses only; a view may start
    anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator type of the kernels (and of their plain versions)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper has launched it."""

    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the Pallas TPU kernel, or of the
    #                      reference function whose plain work it takes
    #                      over where no Pallas kernel computes it
    launches: int = 0


def _src(name: str) -> str:
    return f"src/repro_torch/kernels/csrc/{name}"


KERNELS: Dict[str, Kernel] = {
    "axpy": Kernel("axpy", _src("axpy.cu"), "src/repro/kernels/axpy.py:33"),
    "matmul": Kernel("matmul", _src("matmul.cu"),
                     "src/repro/kernels/matmul.py:38"),
    "atax": Kernel("atax", _src("atax.cu"), "src/repro/kernels/atax.py:40"),
    "covariance": Kernel("covariance", _src("covariance.cu"),
                         "src/repro/kernels/covariance.py:30"),
    "flash_attention": Kernel("flash_attention", _src("flash_attention.cu"),
                              "src/repro/kernels/flash_attention.py:96"),
    "ssm_scan": Kernel("ssm_scan", _src("ssm_scan.cu"),
                       "src/repro/kernels/ssm_scan.py:56"),
    # no Pallas twin: the reference's decode attention is plain XLA
    "decode_attention": Kernel("decode_attention",
                               _src("decode_attention.cu"),
                               "src/repro/models/attention.py:220"),
    # no Pallas twin: the reference's MLA attention is XLA's chunked loop
    "mla_attention": Kernel("mla_attention", _src("mla_attention.cu"),
                            "src/repro/models/attention.py:59"),
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0

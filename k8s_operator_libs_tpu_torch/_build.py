"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface, loaded through :mod:`ctypes`.  The build runs
at first use into ``_build/`` next to this file (listed in
``.gitignore``), under a name carrying the hash of everything the build
reads (the source, every header under ``csrc/`` and the flags), so an
edited source or header rebuilds and an unchanged one loads what is
there.  A missing ``nvcc`` or a failed build raises: there is no
fallback.  :func:`build_all` compiles the sources side by side.

The build keeps what ``ptxas -v`` reports (registers, shared memory,
spills per kernel; :func:`ptxas_report`), and :func:`sass_counts` counts
the tensor-core instructions in a built library's SASS.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
)
HEADER_SUFFIXES = (".cuh", ".h")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
#: argtypes of every C entry point, by library then function.
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "flash_attention": {
        # q, k, v, o, lse, bh, s, d, g, causal, is_bf16, scale, stream
        "flash_fwd": (P, P, P, P, P, I, I, I, I, I, I, F, P),
        # q, k, v, dout, lse, dvec, dq, bh, s, d, g, causal, is_bf16,
        # scale, stream
        "flash_bwd_dq": (P, P, P, P, P, P, P, I, I, I, I, I, I, F, P),
        # q, k, v, dout, lse, dvec, dk, dv, bh, s, d, g, causal, is_bf16,
        # scale, stream
        "flash_bwd_dkv": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P),
    },
    "int8_matmul": {
        # x, q, s, bias (or 0), y, M, K, N, is_bf16, then the bf16 plan
        # (tpu/quantize.py int8_plan): k_warps, cluster; stream
        "int8_linear": (P, P, P, P, P, I, I, I, I, I, I, P),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: wall seconds each library took to build (0.0 when it was already built)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def source_digest(name: str, csrc: Optional[Path] = None) -> str:
    """Hash of what building ``<name>.cu`` reads: the source, every header
    under *csrc* (default :data:`CSRC`) and :data:`NVCC_FLAGS`."""
    csrc = CSRC if csrc is None else Path(csrc)
    headers = sorted(p for p in csrc.rglob("*") if p.suffix in HEADER_SUFFIXES)
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in (csrc / f"{name}.cu", *headers):
        digest.update(b"\0" + str(path.relative_to(csrc)).encode() + b"\0")
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    hash exists; returns the library's path.  The ``ptxas`` report is
    kept beside it."""
    source = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        build_seconds[name] = 0.0
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    build_seconds[name] = time.perf_counter() - t0
    return lib


def build_all(names=None) -> Dict[str, Path]:
    """:func:`build` every library in *names* (default: all of
    :data:`SIGNATURES`), one ``nvcc`` per source, all started together.
    Raises the first failure after every build has ended."""
    names = list(SIGNATURES) if names is None else list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: future.result() for name, future in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use, with the
    ``argtypes`` and ``restype`` of every entry point declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed: CUDA error {status}")


# ------------------------------------------------ what was compiled

_BUILTIN_TYPES = {"b": "bool", "d": "double", "f": "float", "i": "int", "j": "unsigned"}


def demangle(symbol: str) -> str:
    """``kernel<args>`` for the Itanium-mangled name of a kernel template
    whose arguments are types and integers (``_ZN12_GLOBAL__N_119flash_
    fwd_tc_kernelILi64EEEv...`` -> ``flash_fwd_tc_kernel<64>``); any other
    symbol comes back as it is."""
    m = re.match(r"_ZN?", symbol)
    if not m:
        return symbol
    pos, ident = m.end(), None
    while (m := re.match(r"\d+", symbol[pos:])) is not None:  # nested names
        start = pos + m.end()
        ident, pos = symbol[start:start + int(m.group())], start + int(m.group())
    if ident is None or not symbol.startswith("I", pos):
        return ident or symbol
    args, pos = [], pos + 1
    while pos < len(symbol) and symbol[pos] != "E":
        if (m := re.match(r"L[a-z](n?\d+)E", symbol[pos:])) is not None:
            args.append(m.group(1).replace("n", "-"))
        elif (m := re.match(r"(\d+)", symbol[pos:])) is not None:
            start = pos + m.end()
            args.append(symbol[start:start + int(m.group())])
            pos = start + int(m.group())
            continue
        elif symbol[pos] in _BUILTIN_TYPES:
            args.append(_BUILTIN_TYPES[symbol[pos]])
            pos += 1
            continue
        else:
            return symbol
        pos += m.end()
    return f"{ident}<{', '.join(args)}>"


def parse_ptxas(text: str) -> Dict[str, Dict]:
    """Per kernel (demangled), what ``ptxas -v`` reported: ``registers``,
    ``smem_bytes`` (static), ``stack_bytes``, ``spill_stores`` and
    ``spill_loads`` (bytes), and under ``notes`` each coded message that
    names it (``C7515 Potential Performance Loss: wgmma.mma_async
    instructions are serialized ...``)."""
    kernels: Dict[str, Dict] = {}
    notes: Dict[str, list] = {}
    current = None
    for line in text.splitlines():
        if (m := re.search(r"\((C\d+)\) (.*?)(?: in the function)? '([^']+)'", line)) is not None:
            notes.setdefault(demangle(m.group(3)), []).append(f"{m.group(1)} {m.group(2)}")
        elif (m := re.search(r"Compiling entry function '([^']+)'", line)) is not None:
            current = demangle(m.group(1))
            kernels[current] = dict.fromkeys(
                ("registers", "smem_bytes", "stack_bytes", "spill_stores", "spill_loads"), 0
            )
        elif (m := re.search(r"Function properties for (\S+)", line)) is not None:
            name = demangle(m.group(1))
            current = name if name in kernels else None  # not an entry point
        elif current is None:
            continue
        elif (m := re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line
        )) is not None:
            kernels[current].update(
                stack_bytes=int(m.group(1)),
                spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)),
            )
        elif (m := re.search(r"Used (\d+) registers", line)) is not None:
            kernels[current]["registers"] = int(m.group(1))
            if (m := re.search(r"(\d+) bytes smem", line)) is not None:
                kernels[current]["smem_bytes"] = int(m.group(1))
    for name, found in notes.items():
        if name in kernels:
            kernels[name]["notes"] = found
    return kernels


def ptxas_report(name: str) -> Dict[str, Dict]:
    """:func:`parse_ptxas` of the report kept when library *name* was
    built (empty when there is none)."""
    report = library_path(name).with_suffix(".ptxas.txt")
    return parse_ptxas(report.read_text()) if report.exists() else {}


#: The tensor-core instructions: HGMMA (wgmma) and HMMA (mma.sync).
TENSOR_CORE_OPCODES = ("HGMMA", "HMMA")


def parse_sass(text: str) -> Dict[str, Dict[str, int]]:
    """Per function (demangled) of a ``cuobjdump --dump-sass`` listing,
    how many instructions of each of :data:`TENSOR_CORE_OPCODES` it
    holds."""
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if (m := re.search(r"Function : (\S+)", line)) is not None:
            current = demangle(m.group(1))
            counts[current] = dict.fromkeys(TENSOR_CORE_OPCODES, 0)
        elif current is not None:
            for op in TENSOR_CORE_OPCODES:
                if re.search(rf"\b{op}\b", line):
                    counts[current][op] += 1
    return counts


def sass_counts(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_sass` of the built library *name*, through the
    ``cuobjdump`` beside ``nvcc``."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run(
        [str(cuobjdump), "--dump-sass", str(build(name))],
        capture_output=True, text=True, check=True,
    )
    return parse_sass(proc.stdout)

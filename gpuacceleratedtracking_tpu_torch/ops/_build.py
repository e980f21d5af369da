"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, which is loaded with
``ctypes``. The builds run at first use, one ``nvcc`` per source, all started
together, into ``build/torch_kernels/`` at the repository root; a library's
name carries a hash of its source and the flags, so a stale build is never
loaded. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points per source: source stem -> {name: (argtypes, restype)}.
SIGNATURES = {
    "bank_rows": {
        "bank_rows_launch": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P,   # sre sim code params base deltas partial out_re out_im
             _I, _I, _I, _I, _I, _I,               # ants taps samples k code_length tile
             _F, _F,                               # rho_nom fcar_nom_cyc
             _P],                                  # stream
            _I,
        ),
    },
    "bank_comp": {
        "bank_comp_launch": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P,   # sre sim code params base deltas partial out_re out_im
             _I, _I, _I, _I, _I, _I, _I, _I,       # ants taps samples k code_length phase_tile span bf16
             _F, _F,                               # rho_nom fcar_nom_cyc
             _P],                                  # stream
            _I,
        ),
    },
}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {candidate}")
    return str(candidate)


def _sources() -> list[pathlib.Path]:
    return [CSRC_DIR / f"{stem}.cu" for stem in SIGNATURES]


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library for ``source`` and the current flags lives."""
    digest = hashlib.sha256()
    digest.update(source.name.encode())
    digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build() -> list[pathlib.Path]:
    """Compile every ``csrc/*.cu`` whose hashed library is missing; return the
    libraries' paths, one per source.

    One ``nvcc`` per source, all started together. Each compiler's
    ``-Xptxas -v`` report (registers, shared memory and spills per kernel) is
    kept beside its library, as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(src) for src in _sources()]
    jobs = []
    for src, out in zip(_sources(), outs):
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, proc, tmp, out))
    failures = []
    for cmd, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """Build if needed, load the library of ``csrc/<stem>.cu``, and declare
    its entry points' C signatures."""
    build()
    lib = ctypes.CDLL(str(library_path(CSRC_DIR / f"{stem}.cu")))
    for name, (argtypes, restype) in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib

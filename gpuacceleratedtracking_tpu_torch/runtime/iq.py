"""ctypes binding to the native IQ ingest library (``native/iqstream``).

Port of `gpuacceleratedtracking_tpu.runtime.iq`, kept as a copy because the
JAX package's ``__init__`` imports jax. It compiles the same source,
``native/iqstream/iqstream.cpp``, with g++ and the same flags, on first use,
into ``build/torch_kernels/libiqstream_<hash>.so`` beside the port's CUDA
libraries (the hash covers the source and the flags; the library is written
under a temporary name and renamed into place, so concurrent processes never
load a half-written file). Without a compiler, `decode` and `IQFile` fall back
to NumPy; `IQRing` and `Resampler` need the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np

FORMATS = {"int8": 0, "int16": 1, "float32": 2}
_DTYPES = {"int8": np.int8, "int16": np.int16, "float32": np.float32}

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "iqstream" / "iqstream.cpp"
BUILD_DIR = _ROOT / "build" / "torch_kernels"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libiqstream_{digest.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    signatures = {
        "iq_decode": ([vp, ctypes.c_int, i64, ctypes.c_float, f32p, f32p], ctypes.c_int),
        "iqfile_open": ([ctypes.c_char_p, ctypes.c_int], vp),
        "iqfile_read": ([vp, i64, ctypes.c_float, f32p, f32p], i64),
        "iqfile_num_samples": ([vp], i64),
        "iqfile_close": ([vp], None),
        "iqring_create": ([i64], vp),
        "iqring_size": ([vp], i64),
        "iqring_push": ([vp, f32p, f32p, i64], i64),
        "iqring_pop_block": ([vp, f32p, f32p, i64], i64),
        "iqring_destroy": ([vp], None),
        "resampler_create": ([i64, i64, ctypes.c_int, ctypes.c_double], vp),
        "resampler_out_count": ([vp, i64], i64),
        "resampler_process": ([vp, f32p, f32p, i64, f32p, f32p, i64], i64),
        "resampler_destroy": ([vp], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> Optional[ctypes.CDLL]:
    """Build if needed and load the library; None where g++ or the build fails."""
    try:
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(_SRC)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return _declare(ctypes.CDLL(str(out)))
    except (OSError, subprocess.SubprocessError):
        return None


def native_available() -> bool:
    return _library() is not None


def _native() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native iqstream library unavailable")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode(raw: bytes | np.ndarray, fmt: str, scale: float = 1.0):
    """Decode interleaved complex samples into SoA (re, im) float32 planes."""
    code = FORMATS[fmt]
    raw = np.frombuffer(raw, dtype=_DTYPES[fmt]) if isinstance(raw, bytes) else raw
    num = raw.size // 2
    out_re = np.empty(num, np.float32)
    out_im = np.empty(num, np.float32)
    lib = _library()
    if lib is not None:
        rc = lib.iq_decode(
            raw.ctypes.data_as(ctypes.c_void_p), code, num,
            ctypes.c_float(scale), _fptr(out_re), _fptr(out_im),
        )
        if rc != 0:
            raise RuntimeError(f"iq_decode failed: {rc}")
    else:  # NumPy fallback
        x = raw.astype(np.float32) * scale
        out_re, out_im = np.ascontiguousarray(x[0::2]), np.ascontiguousarray(x[1::2])
    return out_re, out_im


class IQFile:
    """Block reader over a raw interleaved-complex capture file."""

    def __init__(self, path: str | pathlib.Path, fmt: str = "int8",
                 scale: float = 1.0):
        self.path = pathlib.Path(path)
        self.fmt = fmt
        self.scale = scale
        self._lib = _library()
        self._h = None
        self._f = None
        if self._lib is not None:
            self._h = self._lib.iqfile_open(str(self.path).encode(), FORMATS[fmt])
            if not self._h:
                raise FileNotFoundError(path)
        else:
            self._f = open(self.path, "rb")

    @property
    def num_samples(self) -> int:
        if self._h is not None:
            return int(self._lib.iqfile_num_samples(self._h))
        bytes_per = 2 * np.dtype(_DTYPES[self.fmt]).itemsize
        return os.path.getsize(self.path) // bytes_per

    def read(self, num_samples: int):
        """Read the next block as SoA float32 planes (short read at EOF)."""
        if self._h is not None:
            out_re = np.empty(num_samples, np.float32)
            out_im = np.empty(num_samples, np.float32)
            got = int(self._lib.iqfile_read(
                self._h, num_samples, ctypes.c_float(self.scale),
                _fptr(out_re), _fptr(out_im),
            ))
            return out_re[:got], out_im[:got]
        bytes_per = 2 * np.dtype(_DTYPES[self.fmt]).itemsize
        raw = self._f.read(num_samples * bytes_per)
        return decode(raw, self.fmt, self.scale)

    def close(self):
        if self._h is not None:
            self._lib.iqfile_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Resampler:
    """Streaming polyphase rational resampler (native C++).

    Converts front-end sample rates (10.000, 16.368, 25.000 MS/s ...) to the
    power-of-two rates the kernels like (8.192, 32.768 MS/s) by a rational
    factor ``up/down`` with a Kaiser-windowed-sinc anti-aliasing prototype.
    Carries filter history across `process` calls, so chunked input (file
    reads, ring pops) yields output identical to one-shot conversion.

    >>> rs = Resampler.for_rates(10.0e6, 8.192e6)   # up=512, down=625
    >>> out_re, out_im = rs.process(re, im)
    """

    def __init__(self, up: int, down: int, taps_per_phase: int = 24,
                 kaiser_beta: float = 8.0):
        lib = _native()
        g = np.gcd(int(up), int(down))
        self.up, self.down = int(up) // g, int(down) // g
        self._lib = lib
        self._h = lib.resampler_create(
            self.up, self.down, int(taps_per_phase), float(kaiser_beta)
        )
        if not self._h:
            raise MemoryError("resampler_create failed")

    @classmethod
    def for_rates(cls, fs_in: float, fs_out: float, max_den: int = 1 << 15,
                  **kw) -> "Resampler":
        """Build from sample rates; the ratio must be rational within
        ``max_den`` (true for any pair of real front-end/kernel rates)."""
        from fractions import Fraction

        frac = Fraction(fs_out / fs_in).limit_denominator(max_den)
        got = fs_in * frac.numerator / frac.denominator
        if abs(got - fs_out) > 1e-6 * fs_out:
            raise ValueError(
                f"rate ratio {fs_out}/{fs_in} not rational within 1/{max_den}"
            )
        return cls(frac.numerator, frac.denominator, **kw)

    def process(self, re: np.ndarray, im: np.ndarray):
        """Consume SoA input planes; return the resampled SoA planes."""
        re = np.ascontiguousarray(re, np.float32)
        im = np.ascontiguousarray(im, np.float32)
        n_out = int(self._lib.resampler_out_count(self._h, re.size))
        out_re = np.empty(n_out, np.float32)
        out_im = np.empty(n_out, np.float32)
        got = int(self._lib.resampler_process(
            self._h, _fptr(re), _fptr(im), re.size,
            _fptr(out_re), _fptr(out_im), n_out,
        ))
        return out_re[:got], out_im[:got]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.resampler_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class IQRing:
    """Lock-free SPSC ring of SoA samples (front-end thread -> tracker)."""

    def __init__(self, capacity: int):
        lib = _native()
        self._lib = lib
        self._h = lib.iqring_create(capacity)
        if not self._h:
            raise MemoryError("iqring_create failed")

    def __len__(self) -> int:
        return int(self._lib.iqring_size(self._h))

    def push(self, re: np.ndarray, im: np.ndarray) -> int:
        re = np.ascontiguousarray(re, np.float32)
        im = np.ascontiguousarray(im, np.float32)
        return int(self._lib.iqring_push(self._h, _fptr(re), _fptr(im), re.size))

    def pop_block(self, num_samples: int):
        """Pop exactly one correlator block, or None if not yet buffered."""
        out_re = np.empty(num_samples, np.float32)
        out_im = np.empty(num_samples, np.float32)
        got = int(self._lib.iqring_pop_block(self._h, _fptr(out_re),
                                             _fptr(out_im), num_samples))
        if got == 0:
            return None
        return out_re, out_im

    def close(self):
        if getattr(self, "_h", None):
            self._lib.iqring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

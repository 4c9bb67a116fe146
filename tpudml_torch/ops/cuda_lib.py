"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``tpudml_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first use,
into ``tpudml_torch/_build/`` (keyed by a hash of the source and the flags),
and loaded with ``ctypes``. Nothing is compiled when a module is imported:
the package imports on a machine with no ``nvcc`` and no card, where every
wrapper runs its plain PyTorch version on CPU tensors.

A :class:`Kernel` is one entry point of a library as the wrappers see it: it
launches the C function on PyTorch's current stream, raises on a non-zero
``cudaError_t``, and counts its launches in ``launches`` (a plain integer
that a run resets and reads to show that its main path went through the
kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p  # device pointer or stream
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from tpudml_torch/csrc on the machine that has the card"
    )


class CudaLibrary:
    """One kernel source: its build, its loaded library and the ctypes
    signatures of its C entry points (``{name: argtypes}``; each returns
    an int, the ``cudaError_t`` of its launch)."""

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = CSRC_DIR / source
        self.functions = functions
        self.build_log = ""
        self._lib = None

    @property
    def name(self) -> str:
        return self.source.stem

    def target(self) -> Path:
        # The shared headers (csrc/*.cuh) are part of every source's key.
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc for this source unless the library is built; the
        caller waits with :meth:`finish_build` (several run at once)."""
        if self.target().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.target().with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        tmp = Path(proc.args[-2])  # [..., "-o", tmp, source]
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} (rc {proc.returncode}):\n"
                f"{self.build_log}"
            )
        os.replace(tmp, self.target())
        self.target().with_suffix(".log").write_text(self.build_log)

    def ptxas_log(self) -> str:
        """The ``nvcc``/``ptxas -v`` output of this source's build, kept
        beside the library (empty if the library was built elsewhere)."""
        log = self.target().with_suffix(".log")
        return self.build_log or (log.read_text() if log.exists() else "")

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.target()))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = I
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [I]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        lib = self.load()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err} ({msg})")


class Kernel:
    """One ported TPU kernel as its wrapper launches it."""

    def __init__(self, name: str, library: CudaLibrary, fn: str,
                 replaces: str):
        self.name = name
        self.library = library
        self.fn = fn
        self.replaces = replaces  # file:line of the Pallas kernel
        self.launches = 0

    @property
    def source(self) -> str:
        return str(self.library.source.relative_to(PKG_DIR.parent))

    def launch(self, *args, stream: int | None = None) -> None:
        """Launch on ``stream`` (a ``cudaStream_t`` as an int), by default
        PyTorch's current stream."""
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        self.library.call(self.fn, *args, P(stream))
        self.launches += 1


def build_all(libraries) -> float:
    """Compile every library not yet built, one nvcc per source, all
    started together; returns the wall seconds spent."""
    import time

    t0 = time.perf_counter()
    libs = list(dict.fromkeys(libraries))
    procs = [(lib, lib.start_build()) for lib in libs]
    for lib, proc in procs:
        lib.finish_build(proc)
    for lib in libs:
        lib.load()
    return time.perf_counter() - t0


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # what the f32/bf16 twins take


def check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                       ndim: int, contiguous: bool = True) -> None:
    """Raise unless ``t`` is what a kernel takes: a CUDA tensor of
    ``dtype`` and rank ``ndim``, contiguous (or, with ``contiguous=False``,
    unit-stride along its last axis)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not contiguous and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected unit stride on the last axis")


def storage_twin(x: torch.Tensor, f32: Kernel, bf16: Kernel) -> Kernel:
    """The twin kernel for ``x``'s storage dtype (f32 or bf16); any other
    dtype raises."""
    if x.dtype == torch.float32:
        return f32
    if x.dtype == torch.bfloat16:
        return bf16
    raise TypeError(f"expected one of {STORAGE_DTYPES}, got {x.dtype}")

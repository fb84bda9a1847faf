"""Build, load and count the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``lib<name>-<hash>.so`` inside the build directory, then
loaded with ``ctypes``. The hash covers the kernel's source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one is
loaded as it is. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module, and a
CPU-only install has no ``nvcc``. A wrapper reaches :meth:`Kernel.fn` only for
a CUDA tensor; a failed build raises and is never replaced by the plain
version.

Each :class:`Kernel` carries ``launches``, a plain integer the wrappers add
one to where they launch the kernel, so a run can show which kernels it went
through (``reset_counts`` / ``counts``); a launch the wrapper tags (K6's
separation-fallback launch) is also counted under its tag in ``tagged``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Override with MCPOWER_TORCH_KERNEL_DIR; the default sits inside the package
# (listed in .gitignore).
BUILD_DIR = Path(
    os.environ.get(
        "MCPOWER_TORCH_KERNEL_DIR", Path(__file__).resolve().parent.parent / "_build"
    )
)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# Widest fit the fit kernels (K2, K3, K4, K6, K7, K9, K10, K11, K12) take
# (MCP_DISPATCH_P in csrc/common.cuh); datagen.unsupported stops wider ones.
MAX_FIT_P = 16
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else "nvcc"


class Kernel:
    """One CUDA source, its shared library and its launch count. ``csrc`` is
    the directory of the source and its headers (another tree's, to build
    that tree's kernel beside this one's)."""

    def __init__(self, name: str, source: str, flags: Iterable[str] = (), csrc: Path = CSRC):
        self.name = name
        self.source = source
        self.csrc = Path(csrc)
        self.flags = list(flags)
        self.launches = 0
        self.tagged: Dict[str, int] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def _digest(self) -> str:
        h = hashlib.sha256()
        for path in [self.csrc / self.source] + sorted(self.csrc.glob("*.cuh")):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + self.flags).encode())
        return h.hexdigest()[:12]

    @property
    def lib_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self._digest()}.so"

    @property
    def _tmp_path(self) -> Path:
        # nvcc writes here; the library appears under its final name only
        # once complete, so an interrupted build is never loaded.
        return self.lib_path.with_suffix(f".{os.getpid()}.tmp")

    @property
    def log_path(self) -> Path:
        return self.lib_path.with_suffix(".log")

    def build_command(self) -> List[str]:
        return (
            [_nvcc()]
            + ARCH_FLAGS
            + BASE_FLAGS
            + self.flags
            + ["-I", str(self.csrc), "-o", str(self._tmp_path), str(self.csrc / self.source)]
        )

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library for this source already exists.
        Its output (ptxas register and spill report included) goes to the
        library's ``.log`` file."""
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(self.log_path, "w") as log:
            return subprocess.Popen(
                self.build_command(), stdout=log, stderr=subprocess.STDOUT
            )

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        proc.wait()
        out = self.log_path.read_text()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n{out}"
            )
        os.replace(self._tmp_path, self.lib_path)

    def fn(self, symbol: str, argtypes) -> ctypes._CFuncPtr:
        """The C entry point ``symbol``, building and loading on first use."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.lib_path))
            f = getattr(self._lib, symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f

    def check(self, err: int, tag: Optional[str] = None) -> None:
        """Raise on the cudaError_t a launch returned; count it otherwise
        (under ``tag`` as well, where given)."""
        if err != 0:
            msg = self._lib.mcp_error_string
            msg.argtypes = [ctypes.c_int]
            msg.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.name}: launch failed with CUDA error {err}: "
                f"{msg(err).decode()}"
            )
        self.launches += 1
        if tag is not None:
            self.tagged[tag] = self.tagged.get(tag, 0) + 1


KERNELS: Dict[str, Kernel] = {
    # Bit-identical Philox words and normals need every f32 operation
    # rounded on its own, as the reference's XLA program does.
    "philox_fill": Kernel("philox_fill", "philox_fill.cu", ["--fmad=false"]),
    "grid_suffstats": Kernel("grid_suffstats", "grid_suffstats.cu"),
    # The fits follow the plain versions' operation order without
    # contraction, so flags that hinge on 1e-10 deviance gaps agree.
    "ols_solve": Kernel("ols_solve", "ols_solve.cu", ["--fmad=false"]),
    "reml_intercept": Kernel("reml_intercept", "reml_intercept.cu", ["--fmad=false"]),
    "glm_irls": Kernel("glm_irls", "glm_irls.cu", ["--fmad=false"]),
    "poisson_quantile": Kernel("poisson_quantile", "poisson_quantile.cu", ["--fmad=false"]),
    "glmm_intercept": Kernel("glmm_intercept", "glmm_intercept.cu", ["--fmad=false"]),
    "slope_reml": Kernel("slope_reml", "slope_reml.cu", ["--fmad=false"]),
    "glmm_slope": Kernel("glmm_slope", "glmm_slope.cu", ["--fmad=false"]),
    "joint_reml": Kernel("joint_reml", "joint_reml.cu", ["--fmad=false"]),
    "glmm_extras": Kernel("glmm_extras", "glmm_extras.cu", ["--fmad=false"]),
}


def build_all() -> Dict[str, float]:
    """Build every kernel in parallel (one nvcc per source); return the
    seconds each library took to become available."""
    import time

    t0 = time.perf_counter()
    procs = {name: k.start_build() for name, k in KERNELS.items()}
    took = {}
    try:
        for name, k in KERNELS.items():
            k.finish_build(procs[name])
            took[name] = time.perf_counter() - t0
    finally:  # a failed build raises; leave no nvcc running behind it
        for proc in procs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return took


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.tagged = {}


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def tagged_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(k.tagged) for name, k in KERNELS.items() if k.tagged}


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Validate what a kernel takes: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")

"""Device resolution and the build-and-load of the hand-written CUDA kernels.

Counterpart of `repro/kernels/backend.py`. There is no global kernel switch:
a wrapper looks at its tensor's device. A CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain PyTorch version. Nothing falls
back from one to the other.

Kernels: each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface and loaded with `ctypes`. The
build happens at first use, into `build/kernels/` at the root of the
checkout (listed in `.gitignore`), from the checkout's sources only; the
library's file name carries a hash of its source, so an edited source is
rebuilt and never shadowed by a stale library. `build_kernels` starts one
`nvcc` per source, all at once. Nothing is built or imported from CUDA when
a module is imported.

`pallas_partition_safe` has no counterpart: the reference drops its
single-device Pallas kernels under a mesh of more than one device, and the
port splits a run over ranks only at data extent > 1, on CPU ranks, where
the wrappers take the plain versions by the tensors' device
(`sharding.clients`); at data extent 1 the kernels run as without a mesh.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

DEFAULT_DEVICE = "cuda"

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("mifa_aggregate", "bank_scatter", "paged_bank", "flash_attention",
           "ssd_scan")
# the dtypes the kernels keep stored rows (G, banks, pages, w) in
FLOAT_STORES = (torch.float32, torch.bfloat16)

_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """torch.device for `device`; raises for CUDA when no GPU is present.

    The port never carries on quietly on the CPU: callers that mean the
    CPU (the tests) say device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "expected 'cuda' or 'cpu'")
    return dev


def set_numerics() -> None:
    """Full-precision fp32 on the card. PyTorch's default leaves cuDNN's
    fp32 convolutions in TF32 (about three decimal digits); the port holds
    fp32 parity with the reference, so both TF32 switches are turned off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built from source at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=KERNELS) -> dict[str, Path]:
    """Compile every missing library in parallel; returns name -> path.

    Each library is written under a temporary name and renamed into place,
    so a concurrent build never loads a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, todo[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels((name,))[name]))
        _LIBS[name] = lib
    return lib


def check_tensors(device: torch.device, named: dict) -> None:
    """The input rules every kernel wrapper holds: `named` maps a name to
    (tensor, allowed dtypes, expected shape), and each tensor must have one
    of those dtypes and that shape, lie on `device` and be contiguous."""
    for name, (t, dtypes, shape) in named.items():
        if t.dtype not in dtypes:
            allowed = " or ".join(str(d).removeprefix("torch.")
                                  for d in dtypes)
            raise TypeError(f"{name} must be {allowed}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"shape mismatch: {name} {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def entry_point(library: str, symbol: str, argtypes, device: torch.device):
    """Kernel entry point `symbol` of `library`, typed as `argtypes` plus
    the trailing stream handle and returning the CUDA error code. Raises
    unless `device` is a CUDA device: the wrappers hand CPU tensors to
    their plain versions before they get here."""
    if device.type != "cuda":
        raise ValueError(f"no {symbol} kernel for device {device}")
    fn = getattr(kernel_library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call the entry point `fn(*args, stream)` on `device`'s current
    stream; raises if the launch fails."""
    with torch.cuda.device(device):
        rc = fn(*args, current_stream_handle(device))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def vector_ok(m: int, *tensors: torch.Tensor) -> bool:
    """May a kernel take its 4-wide path: whole groups of 4 columns and
    rows aligned for 4-element vector access?"""
    return m % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def current_stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

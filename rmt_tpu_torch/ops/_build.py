# Builds the port's CUDA kernels with nvcc at first use and loads them
# with ctypes (route (b): a shared library with a plain C interface, no
# PyTorch headers, so a build takes seconds).
#
# Each library is keyed by a hash of its full source text and its own
# flags and built into the build directory (RMT_TORCH_BUILD_DIR, default
# build/ at the repository root, which git ignores). A source that is
# already built is loaded as it is. Nothing here runs at import time.

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _flags(fmad: bool):
    return (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC",
        f"-fmad={'true' if fmad else 'false'}",
        "-Xptxas", "-v",
    )


# The default: every product and sum rounds on its own, as in the
# plain-PyTorch twins (and as the df32 error-free transforms require).
NVCC_FLAGS = _flags(fmad=False)
# For a kernel of dense float32 products held to its twin by a tolerance,
# not bit for bit: contraction into FFMA doubles its arithmetic rate.
NVCC_FLAGS_FMA = _flags(fmad=True)

_loaded: dict[Path, ctypes.CDLL] = {}


def build_dir() -> Path:
    d = os.environ.get("RMT_TORCH_BUILD_DIR")
    return Path(d) if d else CSRC.parent.parent / "build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str, source: str, flags=NVCC_FLAGS) -> Path:
    key = hashlib.sha256(
        (source + "\0" + " ".join(flags)).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{key}.so"


def compile_sources(jobs) -> list[Path]:
    """Build every (name, source_text[, flags]) job that is not built yet
    (flags default to NVCC_FLAGS), all nvcc processes started together.
    Returns the library paths; raises with the compiler's output if any
    build fails. Each build's compiler report (registers, spills) is kept
    beside its library as .log."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths, running = [], []
    for name, source, *rest in jobs:
        flags = rest[0] if rest else NVCC_FLAGS
        lib = library_path(name, source, flags)
        paths.append(lib)
        if lib.exists():
            continue
        src = lib.with_suffix(".cu")
        src.write_text(source)
        fd, tmp = tempfile.mkstemp(dir=out, suffix=".so")
        os.close(fd)
        cmd = [nvcc(), *flags, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((lib, tmp, proc))
    failures = []
    for lib, tmp, proc in running:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{lib.name}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


_KERNELS = ("factor_kernel", "apply_kernel", "real_kernel", "n2_rhs_kernel",
            "ns_step_kernel", "ns_wide_kernel", "ns_wide_rho_kernel")


def compiler_report(lib: Path) -> list[tuple]:
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared bytes) for each kernel in the build report kept beside a
    library; a kernel template instance is named with its arguments, as
    apply_kernel<7,32>."""
    rows, kernel, spill = [], None, (0, 0)
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            for k in _KERNELS:
                if k not in kernel:
                    continue
                t = re.search(k + r"I((?:Li-?\d+E)+)E", kernel)
                kernel = (f"{k}<{','.join(re.findall(r'-?\d+', t.group(1)))}>"
                          if t else k)
                break
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((kernel, int(m.group(1)), *spill,
                         int(smem.group(1)) if smem else 0))
    return rows


def load(name: str, source: str, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The library built from ``source``, building it first if needed."""
    lib = library_path(name, source, flags)
    if lib not in _loaded:
        compile_sources([(name, source, flags)])
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]


def check_operands(name, tensors, shapes) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the
    first one's device, of its shape (kept cheap: it runs on every
    launch, and the integrator's host time bounds its speed)."""
    import torch

    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"float32 tensor on {dev}")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")


def stream(t) -> int:
    """The raw handle of the current CUDA stream of t's device. PyTorch's
    own kernel launchers read it through torch._C._cuda_getCurrentRawStream,
    which skips building a torch.cuda.Stream object on every launch; the
    public torch.cuda.current_stream is the way where that is absent."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")

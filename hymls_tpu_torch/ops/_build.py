"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exports a plain C interface and is compiled at
first use by nvcc into `_build/lib<name>.so` beside the package (a
directory git ignores), then loaded with ctypes.  No PyTorch headers
are involved, so a build takes seconds rather than the minutes of a
torch C++ extension.  A missing nvcc or a failed build raises: there
is no fallback for a kernel that does not build.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per kernel source (ptxas register / spill report)
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: nvcc on PATH, else the toolkit's default
    install location; raises when neither exists."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hymls_tpu_torch cannot be built")
    return nvcc


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _fresh(name: str) -> bool:
    src, so = _paths(name)
    return os.path.exists(so) and os.path.getmtime(so) >= \
        os.path.getmtime(src)


def build(names: Iterable[str]) -> None:
    """Compile every stale source of `names`, one nvcc process per
    source, all started together; raises if any build fails."""
    todo = [n for n in names if not _fresh(n)]
    if not todo:
        return
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        src, so = _paths(name)
        # build into a temporary name and rename: a concurrent loader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((name, so, tmp, p))
    failed = []
    for name, so, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[name] = out
        if p.returncode == 0:
            os.replace(tmp, so)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def ptxas_report(name: str) -> Dict[str, tuple]:
    """`parse_ptxas` of BUILD_LOG[name] (empty if the source was not
    built in this process)."""
    return parse_ptxas(BUILD_LOG.get(name, ""))


def parse_ptxas(text: str) -> Dict[str, tuple]:
    """{kernel instance: (registers, spill store bytes, spill load
    bytes)} from nvcc's output with `-Xptxas -v`.  Instances of the
    package's kernel templates are named as `kernel<type,N,...>`; others
    keep ptxas's mangled name."""
    out, fn, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = _short_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), *spills)
            fn = None
    return out


def _short_name(mangled: str) -> str:
    """`dia_spmm_kernel<double,8,4,1>` for a mangled instance of a
    template `*_kernel` with a float or double and int arguments: the
    name is the one whose length prefix ends where it starts."""
    for m in re.finditer(r"_kernelI([fd])((?:Li\d+E)+)E", mangled):
        e = m.start() + len("_kernel")
        for s in range(m.start(), 0, -1):
            if any(mangled[s - k:s].isdigit() and int(mangled[s - k:s]) ==
                   e - s for k in (1, 2, 3)):
                args = ["float" if m.group(1) == "f" else "double",
                        *re.findall(r"Li(\d+)E", m.group(2))]
                return f"{mangled[s:e]}<{','.join(args)}>"
    return mangled


def load(name: str) -> ctypes.CDLL:
    """The compiled library of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _LIBS[name] = lib
        return lib

"""Build the CUDA kernels of this package and load them with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` compiles each in seconds. They are compiled for Hopper only
(``sm_90a``), one ``nvcc -c`` per source started together, and linked into one
shared library. The library is built at first use, from those sources and
nothing else, into ``_build/`` beside this file (``REPRO_TORCH_KERNEL_DIR``
overrides the directory); its name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.

There is no fallback: without ``nvcc``, or when a source does not compile,
``lib()`` raises. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("act_clip_count.cu", "block_sparse_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last real build took (0.0 when the library was already there)
build_seconds: float = 0.0

_PTR, _INT, _LL, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
#: C signatures; every pointer and the stream is a ``c_void_p`` so that ctypes
#: does not cut a 64-bit address to an int
_SIGNATURES = {
    "hass_act_clip_count_f32":
        (_PTR, _F32, _PTR, _PTR, _LL, _LL, _INT, _INT, _INT, _PTR),
    "hass_act_clip_count_bf16":
        (_PTR, _F32, _PTR, _PTR, _LL, _LL, _INT, _INT, _INT, _PTR),
    "hass_block_sparse_matmul_f32":
        (_PTR, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _PTR),
    "hass_block_sparse_matmul_bf16":
        (_PTR, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _PTR),
}


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_KERNEL_DIR") or \
        os.path.join(_HERE, "_build")


def find_nvcc() -> Optional[str]:
    cands: List[Optional[str]] = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(so: str) -> None:
    """Compile every source at once (one ``nvcc`` each), link, move into
    place. The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept in ``build.log`` beside the library."""
    global build_seconds
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "the CUDA kernels need nvcc to build (looked on PATH, under "
            "CUDA_HOME and /usr/local/cuda) and none was found")
    bdir = os.path.dirname(so)
    os.makedirs(bdir, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=bdir) as td:
        procs = []
        for name in SOURCES:
            obj = os.path.join(td, name[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(CSRC, name)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== nvcc {name} (exit {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if not failed:
            tmp_so = os.path.join(td, "lib.so")
            link = subprocess.run(
                [nvcc, "-shared", "-o", tmp_so, *[o for _, o, _ in procs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (exit {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        text = "\n".join(log)
        with open(os.path.join(bdir, "build.log"), "w") as f:
            f.write(text)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{text[-6000:]}")
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is not there yet."""
    global _LIB
    if _LIB is None:
        so = os.path.join(build_dir(), f"libhass_kernels_{_tag()}.so")
        if not os.path.exists(so):
            _build(so)
        loaded = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = loaded
    return _LIB


def device_guard(t):
    """Context that makes ``t``'s card the current one for a launch; free
    when it already is (the usual case)."""
    import torch
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")

"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each kernel source is a plain ``extern "C"`` launcher. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` (named by a hash of the source, the headers under
``csrc/`` it includes and the flags, so an edited source or header builds
anew) and loaded with ``ctypes``. There is no probing
and no fallback: a missing ``nvcc`` or a failed build raises.

A kernel computes its forward pass only. ``refuse_grad`` is the guard each
CUDA path of a kernel wrapper calls: an input that requires a gradient,
with grad enabled, raises rather than leave the kernel's output cut from
the autograd graph (its gradient silently zero).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# kernel name -> source file under csrc/
SOURCES = {
    "t5_attention_core": "t5_attention_core.cu",
    "int8_encoder": "int8_encoder.cu",
    "cross_attention_decode": "cross_attention_decode.cu",
    "t5_ffn": "t5_ffn.cu",
    "vit_block": "vit_block.cu",
    "vit_whole_block": "vit_whole_block.cu",
    "attention_block": "attention_block.cu",
    "vit_block_q8": "vit_block_q8.cu",
    "gpt2_block": "gpt2_block.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use"
    )


def included_files(name: str) -> List[Path]:
    """The kernel's source and every file under ``csrc/`` that it includes
    with quotes, directly or through another such file, in a fixed order."""
    found: List[Path] = []
    todo = [CSRC_DIR / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for include in _QUOTED_INCLUDE.findall(path.read_text()):
            target = path.parent / include
            if target.is_file():
                todo.append(target)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in included_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all by default), one ``nvcc`` process per
    source, all started together. Sources already built are skipped unless
    ``ptxas_verbose`` asks for the compiler's register / shared-memory /
    spill report, which only a fresh build prints. Returns each built
    kernel's compiler output."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is not there yet."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def refuse_grad(op: str, *tensors: Optional[torch.Tensor],
                vjp: Optional[str] = None) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and any of
    ``tensors`` requires a gradient: kernel ``op`` computes none. ``vjp``
    names the wrapper's autograd form, where it has one."""
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in tensors):
        return
    hint = (f"call {vjp}, its autograd form (the kernel forward, the "
            "gradient through its XLA twin)" if vjp else
            "it has no autograd form, as the JAX package's Pallas kernel "
            "has no custom_vjp")
    raise NotImplementedError(
        f"{op}: the CUDA kernel computes no gradient and an input requires "
        f"one; {hint}")

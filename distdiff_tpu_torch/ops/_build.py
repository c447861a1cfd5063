"""Build and load the CUDA kernels in ``distdiff_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, never at import, into ``csrc/build/<hash>/``, where the hash
covers every source and header and the flags, so an edit rebuilds. All the
sources compile in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (see the sources)
SIGNATURES = {
    "flash_fwd": ("flash_fwd", [_P] * 5 + [_I] * 6 + [_F, _P]),
    "flash_bwd_fused": ("flash_bwd", [_P] * 9 + [_I] * 6 + [_F, _P]),
    "flash_bwd_dq": ("flash_bwd", [_P] * 7 + [_I] * 5 + [_F, _P]),
    "flash_bwd_dkv": ("flash_bwd", [_P] * 8 + [_I] * 5 + [_F, _P]),
    "flash_fwd_f32": ("flash_f32", [_P] * 5 + [_I] * 4 + [_F, _P]),
    "flash_bwd_fused_f32": ("flash_f32", [_P] * 9 + [_I] * 4 + [_F, _P]),
    "flash_bwd_dq_f32": ("flash_f32", [_P] * 7 + [_I] * 4 + [_F, _P]),
    "flash_bwd_dkv_f32": ("flash_f32", [_P] * 8 + [_I] * 4 + [_F, _P]),
    "gn_fused": ("groupnorm", [_P] * 4 + [_I] * 6 + [_F] + [_I] * 6 + [_P]),
    "gn_fused_smem": ("groupnorm", [_I] * 9),
    "gn_empty": ("groupnorm", [_I] * 5 + [_P]),
    "gn_stats": ("groupnorm", [_P] * 6 + [_I] * 6 + [_F] + [_I] * 5 + [_P]),
    "gn_stats_smem": ("groupnorm", [_I] * 8),
    "gn_apply": ("groupnorm", [_P] * 3 + [_I] * 10 + [_P]),
    "gn_smem_optin": ("groupnorm", [_I]),
    "flash_fwd_smem": ("flash_fwd", [_I]),
    "flash_bwd_fused_smem": ("flash_bwd", [_I]),
    "flash_bwd_split_smem": ("flash_bwd", [_I]),
    "flash_fwd_f32_smem": ("flash_f32", [_I]),
    "flash_bwd_f32_smem": ("flash_f32", [_I, _I]),
    "flash_bwd_fused_f32_smem": ("flash_f32", [_I]),
}

_LOCK = threading.Lock()
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                       glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build_all() -> Dict[str, str]:
    """Compile every source not built yet; returns {stem: library path}."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    libs = {}
    procs = []
    t0 = time.time()
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = os.path.join(out_dir, f"lib{stem}.so")
        libs[stem] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, f"{stem}.log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((stem, tmp, lib, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, tmp, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(stem)
        else:
            os.replace(tmp, lib)  # atomic: a half-written library is never loaded
    build_info.update(seconds=time.time() - t0, built=[p[0] for p in procs],
                      dir=out_dir)
    if failed:
        logs = "\n".join(open(os.path.join(out_dir, f"{s}.log")).read()[-4000:]
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


def kernel(name: str):
    """The ctypes function for kernel entry point ``name`` (builds and loads
    the libraries on first call)."""
    with _LOCK:
        if not _FUNCS:
            libs = _build_all()
            loaded = {stem: ctypes.CDLL(path) for stem, path in libs.items()}
            for fn, (stem, argtypes) in SIGNATURES.items():
                f = getattr(loaded[stem], fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _FUNCS[fn] = f
        return _FUNCS[name]


def ptxas_report(log: str):
    """(kernel, registers, stack bytes, spill store bytes, spill load bytes)
    of every kernel in one source's ``-Xptxas -v`` output, each kernel named
    ``name<template arguments>`` from its mangled name."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name, i = mangled, 3 if mangled.startswith("_ZN") else 2
            while i < len(mangled) and mangled[i].isdigit():  # length-prefixed names
                j = i
                while mangled[j].isdigit():
                    j += 1
                n = int(mangled[i:j])
                name, i = mangled[j:j + n], j + n
            args = [a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)E", mangled)]
            out.append([name + (f"<{','.join(args)}>" if args else ""), None, 0, 0, 0])
        elif out:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out[-1][2:] = [int(x) for x in m.groups()]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[-1][1] = int(m.group(1))
    return [tuple(r) for r in out]


def build_logs() -> Dict[str, str]:
    """nvcc's output (ptxas register / shared-memory / spill lines) per
    source of the current build."""
    out_dir = build_info.get("dir")
    if not out_dir:
        return {}
    return {os.path.basename(p)[:-4]: open(p).read()
            for p in sorted(glob.glob(os.path.join(out_dir, "*.log")))}

"""Build-at-first-use of the port's native sources.

Each shared library is compiled from the sources in the checkout into
`hairpt_torch/_build/` (listed in .gitignore), under a file name keyed by
a hash of the sources and the compiler command, and loaded with ctypes.
No PyTorch headers are involved, so a build takes seconds. The library is
written under a temporary name and renamed into place, so processes that
build concurrently never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# seconds spent compiling and the compiler's messages, per library name,
# for the builds this process ran
BUILD_SECONDS: dict = {}
BUILD_LOG: dict = {}


def build_library(name: str, sources, cmd, headers=(),
                  timeout: float = 600.0) -> str:
    """Compile `sources` (file names under csrc/) with `cmd` (the compiler
    and its flags, without sources and output) and return the .so path.
    `headers` (under csrc/) are hashed with the sources."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in paths + [os.path.join(CSRC_DIR, s) for s in headers]:
        with open(p, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        tmp = f"{out}.tmp{os.getpid()}"
        t0 = time.time()
        res = subprocess.run(list(cmd) + ["-o", tmp] + paths,
                             capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.time() - t0
        BUILD_LOG[name] = res.stdout + res.stderr
    return out


def load_library(name: str, sources, cmd, headers=()) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(name, sources, cmd, headers))

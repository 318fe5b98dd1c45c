"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled with ``nvcc`` from the sources in the
checkout into one shared library with a plain C interface, loaded with
``ctypes``.  A build happens at first use (never at import), into
``build/`` at the root of the checkout (listed in ``.gitignore``), under
a name that carries a hash of the sources and flags, so a stale build is
never loaded.  :func:`build_all` starts one ``nvcc`` per missing library
and waits for all of them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

#: Build output directory (listed in ``.gitignore``).
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"

#: Flags every library is built with: Hopper (``sm_90a``), C++17, a
#: shared object, and ptxas's register/spill report.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their csrc/ at first use and need the CUDA toolkit")


class Library:
    """One kernel library: ``main`` (a ``.cu`` in ``csrc``) compiled with
    ``flags``; ``sources`` are every file whose content keys the build.
    ``info`` holds the seconds and the compiler report of the build this
    process made (``seconds`` is 0.0 when an existing build was found)."""

    def __init__(self, name: str, csrc: pathlib.Path, main: str,
                 sources: tuple[str, ...], flags: tuple[str, ...]):
        self.name, self.csrc, self.main = name, csrc, main
        self.sources, self.flags = sources, flags
        self.info: dict = {}
        self._cdll = None

    def path(self) -> pathlib.Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for name in self.sources:
            h.update((self.csrc / name).read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._cdll is None:
            build_all((self,))
            self._cdll = ctypes.CDLL(str(self.path()))
        return self._cdll


def build_all(libs) -> None:
    """Compile every library of ``libs`` whose build is missing: one
    ``nvcc`` each, all started before any is waited for."""
    running = []
    for lib in libs:
        out = lib.path()
        if out.exists():
            lib.info.setdefault("seconds", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *lib.flags, "-o", str(tmp), str(lib.csrc / lib.main)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((lib, out, tmp, proc, time.perf_counter()))
    failed = []
    for lib, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        lib.info.update(seconds=time.perf_counter() - t0,
                        ptxas=stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))

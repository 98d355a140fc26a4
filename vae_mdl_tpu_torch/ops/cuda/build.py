"""Build of the CUDA sources under ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/<name>-<hash>.so``, compiled with ``nvcc`` for ``sm_90a`` at first
use and loaded with ``ctypes`` by its wrapper module. The hash covers the
source, every header under ``csrc/`` and the flags, so an edit to any of them
is a new build. Nothing is built when a module is imported. ``build_all``
starts one ``nvcc`` per missing library, all together, and waits for them.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fast math, no mul+add contraction: the kernels round as the plain
    # versions' elementwise ops do (see csrc/dl_cascade.cuh)
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the kernels are built "
            "from vae_mdl_tpu_torch/csrc/ with the CUDA toolkit")
    return path


def library_path(source: Path) -> Path:
    """Where the build of ``source`` with the current headers and flags lives."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> List[Path]:
    """Compile each source's library unless that exact build exists, the
    missing ones in parallel; returns the libraries' paths in order. The
    compiler's register/spill report goes beside each as ``.log``."""
    libs = [library_path(source) for source in sources]
    running = []
    for source, lib in zip(sources, libs):
        if lib.exists():
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        # the compiler writes straight into the log, so no pipe can fill
        # while another build is waited for
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                    stdout=log, stderr=subprocess.STDOUT)
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        if proc.wait() != 0:
            failed.append(f"nvcc failed on {source}:\n{lib.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(source: Path) -> Path:
    """``build_all`` for one source."""
    return build_all([source])[0]


def mufu_counts(lib: Path) -> Optional[Dict[str, Dict[str, int]]]:
    """``{mangled kernel name: {MUFU kind: instructions}}`` from the SASS of
    a built library (``cuobjdump -sass``): the special-function instructions
    in each kernel's listing, every branch included. None where the toolkit
    has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        beside_nvcc = Path(_nvcc()).with_name("cuobjdump")
        if not beside_nvcc.exists():
            return None
        tool = str(beside_nvcc)
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    for section in sass.split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        kinds: Dict[str, int] = {}
        for kind in re.findall(r"\bMUFU\.(\w+)", body):
            kinds[kind] = kinds.get(kind, 0) + 1
        counts[name.strip()] = kinds
    return counts

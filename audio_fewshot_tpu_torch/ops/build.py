"""Build hand-written CUDA sources into shared libraries with ``nvcc``.

Each library has a plain C interface and is loaded with ``ctypes``.  It is
built at first use from the package's ``csrc/`` sources into
``build/kernels/`` beside the package; the file name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
reused.  The ``*.cuh`` headers in a source's directory, which the sources
include by relative path, are part of the hash.  ``nvcc``'s output (the
``-Xptxas -v`` register and shared-memory report) is kept beside the
library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "-ldl",  # kernels look libcuda's tensor-map encoder up with dlsym
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``; raises
    ``FileNotFoundError`` if neither exists."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append(shutil.which("nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise FileNotFoundError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "CUDA kernels"
    )


def build_library(
    name: str, sources: Sequence[Path], extra_flags: Sequence[str] = ()
) -> Path:
    """Path of ``lib<name>-<hash>.so`` built from ``sources`` (reused when
    already built).  ``extra_flags`` (``-D...``) come after ``NVCC_FLAGS``
    and are part of the hash, as are the headers beside the sources."""
    sources = [Path(s) for s in sources]
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted({h for src in sources for h in src.parent.glob("*.cuh")})
    for src in [*sources, *headers]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out

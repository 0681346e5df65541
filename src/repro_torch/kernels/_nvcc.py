"""Build a directory of CUDA sources into a shared library with ``nvcc``.

Each kernel library of the port (``kernels/cms``, ``kernels/attention``)
keeps its sources in ``csrc/`` and is compiled at first use into a
``_build/`` directory beside them (listed in ``.gitignore``), as a shared
library with a plain C interface that the library's wrapper module loads
with ``ctypes``. The library's name carries a hash of its sources and
flags, so an edit rebuilds and an unchanged tree reuses the build.
Importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "build_library"]

#: Hopper with its architecture-specific features (``sm_90a``), a shared
#: library with position-independent code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the kernels")
    return nvcc


def build_library(name: str, package_dir: pathlib.Path,
                  flags: tuple[str, ...] = NVCC_FLAGS) -> pathlib.Path:
    """Compile ``package_dir/csrc/*.cu`` into ``package_dir/_build/lib<name>_<hash>.so``
    unless a library of the same sources and flags is already there."""
    sources = sorted((package_dir / "csrc").glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {package_dir / 'csrc'}")
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.read_bytes())
    build = package_dir / "_build"
    lib = build / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build)
    os.close(fd)
    try:
        cmd = [_nvcc(), *flags, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib

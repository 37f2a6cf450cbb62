"""Build the CUDA sources in ``csrc/`` into shared libraries with ``nvcc``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` under
the checkout (listed in ``.gitignore``), where ``<hash>`` covers every file
in ``csrc/`` and the flags, so a changed source rebuilds and an unchanged one
is reused.  The libraries have a plain C interface and are bound with
``ctypes``: no PyTorch headers, so a build takes seconds.  All sources are
compiled at once, one ``nvcc`` each, on first use; nothing runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_built: dict[str, Path] = {}


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch finds it,
    else ``nvcc`` on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, all in parallel.

    Returns ``{name: path of the .so}``.  Raises ``RuntimeError`` with the
    compiler's output when a source does not compile.  ``nvcc``'s ptxas
    report (registers, shared memory, spills) is kept beside each library
    as ``<name>-<hash>.log``.
    """
    if _built:
        return dict(_built)
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        _built[src.stem] = out
        if not out.exists():
            todo[src.stem] = (src, out)
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
        if failed:
            _built.clear()
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return dict(_built)

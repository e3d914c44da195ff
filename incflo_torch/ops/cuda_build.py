"""Build and bind the hand-written CUDA sources of incflo_torch/csrc:
nvcc into a shared library with a plain C interface, loaded with ctypes.
A library is built at first use into incflo_torch/_build/ under a name
keyed on a hash of its source and the compiler flags, so an edited source
is rebuilt and an unchanged one is not.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: each operation rounds as the plain
              # version's does, so the two agree to the last bits
              "-fmad=false"]

# dtype codes of the C entry points
DT_CODE = {torch.float32: 0, torch.float64: 1}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return exe


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def _ptxas_summary(name: str, stderr: str) -> str:
    """One line per kernel of nvcc's -Xptxas -v report: its registers,
    stack and spills."""
    lines, entry = [], None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "Used" in line and "registers" in line:
            lines.append(f"[ptxas] {name} {entry}: {line.split(':', 1)[1].strip()}")
        elif entry and "spill" in line:
            lines.append(f"[ptxas] {name} {entry}: {line.strip()}")
    return "\n".join(lines)


def build(source: Path, ptxas_verbose: bool = False) -> Path:
    """Compile `source` unless this source's library exists.  Returns the
    library path; with ptxas_verbose it is compiled in any case and each
    kernel's registers, stack and spills are printed."""
    out = library_path(source)
    if out.exists() and not ptxas_verbose:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}) on {source.name}:"
                           f"\n{r.stderr}")
    if ptxas_verbose:
        print(_ptxas_summary(source.name, r.stderr), flush=True)
    os.replace(tmp, out)
    return out


def build_all(sources: Sequence[Path],
              ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Build several sources at once, one nvcc process each."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futs = {s.name: pool.submit(build, s, ptxas_verbose)
                for s in sources}
        return {name: f.result() for name, f in futs.items()}


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def ptr(t: torch.Tensor, comp: int = 0) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() + comp * t.element_size())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)

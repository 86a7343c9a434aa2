"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain ``extern "C"`` interface (no PyTorch headers, so a build takes
seconds). All missing libraries are built together, one ``nvcc`` process
per source started at once. Libraries land in ``build/kernels/`` at the
root of the checkout, named by a hash of their sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# source name -> {C function: argument types}; every function returns the
# cudaError_t of its launches as an int
SIGNATURES = {
    "scatter_min": {"scatter_min_i32": (_P, _P, _P, _P, _I64, _I64, _P)},
    "pointer_jump": {"pointer_jump_i32": (_P, _P, _I64, _I32, _P)},
    "hook_compress": {
        "hook_compress_i32": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _P)},
    "edge_relabel": {
        "edge_relabel_i32": (_P, _P, _P, _P, _I64, _I64, _P),
        "edge_rewrite_i32": (_P, _P, _P, _P, _P, _I64, _I64, _P)},
    "embedding_bag": {
        # tables, rows, row_lo and rows_global, host arrays of T int64
        # (csrc's bag_tables), T, idx, out, B, L, D, mode, stream
        **{name: (_P, _P, _P, _P, _I64, _P, _P, _I64, _I64, _I64, _I32, _P)
           for name in ("embedding_bags_f32", "embedding_bags_bf16")},
        # the backward's first six: host arrays of T int64 (bag_tables)
        "embedding_bag_backward_keys_f32": (
            _P, _P, _P, _P, _P, _P, _I64, _P, _P, _I32, _P, _P, _I64, _I64,
            _I64, _I32, _P),
        "embedding_bag_backward_f32": (
            _P, _P, _P, _P, _P, _P, _I64, _P, _I32, _P, _P, _P, _P, _P, _P,
            _I64, _I64, _I64, _I64, _I32, _P)},
    "segment": {
        # values, the sorted positions' ids, out, the address of the plan's
        # Layout, d, stream
        name: (_P, _P, _P, _P, _I64, _P)
        for name in ("segment_sum_f32", "segment_sum_bf16", "gather_sum_f32",
                     "gather_sum_bf16")},
    "threefry": {
        "threefry_bits_i64": (_P, _I64, _I64, _I64, _I64, _P),
        "threefry_randint_i32": (
            _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P)},
}


@dataclass(frozen=True)
class BuildRecord:
    """One library: where it is, and what building it took (0 s if cached)."""

    name: str
    path: Path
    seconds: float
    ptxas: tuple  # the compiler's register/spill lines, kept beside the library


_LIBS: dict = {}      # name -> loaded ctypes.CDLL
_RECORDS: dict = {}   # name -> BuildRecord of this process's first load


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit")
    return path


def _library_path(name: str, csrc: Path = CSRC,
                  build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(csrc.glob("*.cuh")), csrc / f"{name}.cu"):
        h.update(src.read_bytes())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


def _ptxas_log(path: Path) -> Path:
    return path.with_suffix(".ptxas.txt")


def build_all(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
              names=tuple(SIGNATURES)) -> dict:
    """Build each library of ``names`` from the sources in ``csrc`` that is
    not built yet in ``build_dir``, all ``nvcc`` processes at once; return
    ``{name: BuildRecord}``. Another source tree (a parent commit's, say)
    builds beside this checkout's without touching what ``load`` uses."""
    build_dir.mkdir(parents=True, exist_ok=True)
    records, pending = {}, {}
    for name in names:
        path = _library_path(name, csrc, build_dir)
        if path.exists():
            log = _ptxas_log(path)
            ptxas = tuple(log.read_text().splitlines()) if log.exists() else ()
            records[name] = BuildRecord(name, path, 0.0, ptxas)
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in pending.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        ptxas = tuple(line.strip() for line in out.splitlines()
                      if "ptxas info" in line or "spill" in line)
        _ptxas_log(path).write_text("\n".join(ptxas))
        os.replace(tmp, path)
        records[name] = BuildRecord(name, path, seconds, ptxas)
    if failed:
        raise RuntimeError(f"nvcc failed in {csrc} for " + "\n".join(failed))
    if csrc == CSRC and build_dir == BUILD_DIR:
        # the first record of a name stays: it says what this process built
        for name, rec in records.items():
            _RECORDS.setdefault(name, rec)
    return records


def open_library(rec: BuildRecord) -> ctypes.CDLL:
    """Load a built library with its entry points' argument types set."""
    lib = ctypes.CDLL(str(rec.path))
    for fn, argtypes in SIGNATURES[rec.name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        if name not in _RECORDS:
            build_all()
        _LIBS[name] = open_library(_RECORDS[name])
    return _LIBS[name]


def check_args(what: str, labels, *edge_arrays) -> None:
    """Validate a kernel call: 1-D contiguous int32 tensors on one CUDA
    device, with the edge-indexed arrays all of one length."""
    tensors = (labels, *edge_arrays)
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: the CUDA kernel takes int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: needs 1-D contiguous tensors, got "
                             f"shape {tuple(t.shape)}")
        if t.device.type != "cuda" or t.device != labels.device:
            raise ValueError(f"{what}: needs tensors on one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
    if len({t.shape[0] for t in edge_arrays}) > 1:
        raise ValueError(f"{what}: edge arrays differ in length: "
                         f"{[t.shape[0] for t in edge_arrays]}")


def check_table_args(what: str, table, idx, *, dtypes: tuple) -> None:
    """Validate a table-gather call: a 2-D contiguous ``table`` of one of
    ``dtypes`` with at least one row, and a 2-D contiguous int32 ``idx``,
    both on one CUDA device."""
    if table.dtype not in dtypes:
        raise TypeError(f"{what}: the CUDA kernel takes a table of "
                        f"{[str(d) for d in dtypes]}, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes int32 ids, got "
                        f"{idx.dtype}")
    for t in (table, idx):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what}: needs 2-D contiguous tensors, got "
                             f"shape {tuple(t.shape)}")
    if table.shape[0] == 0:
        raise ValueError(f"{what}: the table has no rows")
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"{what}: needs tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (table, idx)]}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device (a
    ``Stream`` object a call costs microseconds, which a small kernel call
    notices)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")

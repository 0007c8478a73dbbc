"""Build and load the hand-written CUDA kernels of ``dfc_sa_unet_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  The builds
run in parallel, one ``nvcc`` per source, at the first call that needs a
kernel, never at import.  Libraries land in ``dfc_sa_unet_torch/_build/``
(git-ignored), or in the directory given to ``set_build_dir`` (the CLIs'
``--exe_cache``), under a name that carries a hash of the sources, the
flags and ``nvcc --version``, so an edited source or a new toolkit is
rebuilt and a stale library is never loaded.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: name -> (source stem, argtypes); every one returns
# cudaGetLastError() as an int
SIGNATURES = {
    "pooled_attention_f32": ("pooled_attention", [_P] * 4 + [_I] * 5 + [_P]),
    "pooled_attention_long_f32": ("pooled_attention", [_P] * 4 + [_I] * 5 + [_P]),
    "pooled_attention_wgmma_bf16": ("pooled_attention", [_P] * 4 + [_I] * 5 + [_P]),
    "conv3x3_bn_relu_f32": ("dfc_tail", [_P] * 4 + [_I] * 5 + [_P]),
    "conv3x3_bn_relu_bf16": ("dfc_tail", [_P] * 4 + [_I] * 7 + [_P]),
    "dfc_tail_f32": ("dfc_tail", [_P] * 10 + [_I] * 5 + [_P]),
    "dfc_tail_bf16": ("dfc_tail", [_P] * 10 + [_I] * 5 + [_P]),
    # the same over a band of rows: the halo rows top and bottom after the operands (null: the image's edge)
    "conv3x3_bn_relu_halo_f32": ("dfc_tail", [_P] * 6 + [_I] * 5 + [_P]),
    "conv3x3_bn_relu_halo_bf16": ("dfc_tail", [_P] * 6 + [_I] * 7 + [_P]),
    "dfc_tail_halo_f32": ("dfc_tail", [_P] * 12 + [_I] * 5 + [_P]),
    "dfc_tail_halo_bf16": ("dfc_tail", [_P] * 12 + [_I] * 5 + [_P]),
    "mha_f32": ("mha", [_P] * 4 + [_I] * 5 + [_P]),
    "mha_bf16": ("mha", [_P] * 4 + [_I] * 5 + [_P]),
    "mha_wgmma_bf16": ("mha", [_P] * 4 + [_I] * 5 + [_P]),
    "conv3x3_bias_stats_f32": ("conv_bn_stats", [_P] * 6 + [_I] * 5 + [_P]),
    "conv3x3_bias_stats_bf16": ("conv_bn_stats", [_P] * 6 + [_I] * 7 + [_P]),
    "probe_matmul_bf16": ("mxu_probes", [_P] * 3 + [_I] * 3 + [_P]),
    "probe_conv_cat_bf16": ("mxu_probes", [_P] * 3 + [_I] * 5 + [_P]),
    "probe_conv_9dot_bf16": ("mxu_probes", [_P] * 3 + [_I] * 5 + [_P]),
    "conv3x3_s8_bf16": ("conv3x3_s8", [_P] * 5 + [_I] * 6 + [_P]),
    "conv3x3_s8_f32": ("conv3x3_s8", [_P] * 5 + [_I] * 6 + [_P]),
    "conv3x3_s8_halo_bf16": ("conv3x3_s8", [_P] * 7 + [_I] * 6 + [_P]),
    "conv3x3_s8_halo_f32": ("conv3x3_s8", [_P] * 7 + [_I] * 6 + [_P]),
}

_functions = None
_loaded_from = None  # the directory the loaded libraries came from


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def set_build_dir(path) -> None:
    """Build the libraries in, and load them from, ``path`` (created at the first build).  Raises
    when the kernels were already loaded from another directory."""
    global BUILD_DIR
    path = Path(path).expanduser().resolve()
    if _loaded_from is not None and path != _loaded_from:
        raise RuntimeError(f"the CUDA kernels were already loaded from {_loaded_from}; cannot switch to {path}")
    BUILD_DIR = path


@functools.cache
def _nvcc_version() -> str:
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True).stdout


def _digest(stem: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version().encode())
    for src in [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def build() -> dict:
    """Compile every missing library in parallel; returns {stem: .so path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stems = sorted({stem for stem, _ in SIGNATURES.values()})
    libs, jobs = {}, []
    for stem in stems:
        so = BUILD_DIR / f"lib{stem}-{_digest(stem)}.so"
        libs[stem] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        with open(BUILD_DIR / f"{stem}.log", "w", encoding="utf-8") as log:
            jobs.append((stem, so, tmp, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, so, tmp, proc in jobs:
        rc = proc.wait()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{stem} (rc {rc}):\n" + (BUILD_DIR / f"{stem}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def kernel(name: str):
    """The ctypes function ``name`` of SIGNATURES, building on first use."""
    global _functions, _loaded_from
    if _functions is None:
        major, minor = torch.cuda.get_device_capability()
        if (major, minor) != (9, 0):
            raise RuntimeError(f"the kernels are built for sm_90a (H100); this card is sm_{major}{minor}")
        loaded = {stem: ctypes.CDLL(str(path)) for stem, path in build().items()}
        _loaded_from = BUILD_DIR
        fns = {}
        for fname, (stem, argtypes) in SIGNATURES.items():
            fn = getattr(loaded[stem], fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fname] = fn
        _functions = fns
    return _functions[name]


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

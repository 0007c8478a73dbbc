"""Build, load and call the hand-written CUDA kernels of ``dfc_sa_unet_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  The builds
run in parallel, one ``nvcc`` per source, at the first call that needs a
kernel, never at import.  Libraries land in ``dfc_sa_unet_torch/_build/``
(git-ignored), or in the directory given to ``set_build_dir`` (the CLIs'
``--exe_cache``), under a name that carries a hash of the sources, the
flags and ``nvcc --version``, so an edited source or a new toolkit is
rebuilt and a stale library is never loaded.

This module is also the one seam through which the wrappers of ``ops/`` call a kernel: ``on_cpu``
(every operand on the CPU: the wrapper runs its plain version), ``check_operands`` (the device,
dtype, layout and grad rules they share), ``launch`` (the entry point on the current stream, its
error checked, the launch counted in ``LAUNCHES``) and ``PlainBackward`` (a kernel's forward under
autograd, its backward recomputed through the plain version).  Adding a kernel takes a
``csrc/<name>.cu``, its ``SIGNATURES`` lines with its counted name in ``LAUNCHES`` beside them, and a
wrapper that calls these.
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# exported C functions: name -> (source stem, argtypes); every one returns
# cudaGetLastError() as an int
SIGNATURES = {
    "pooled_attention_f32": ("pooled_attention", [_P] * 4 + [_I] * 9 + [_P]),
    "pooled_attention_long_f32": ("pooled_attention", [_P] * 4 + [_I] * 9 + [_P]),
    "pooled_attention_wgmma_bf16": ("pooled_attention", [_P] * 4 + [_I] * 9 + [_P]),
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
    "lsa_epilogue_f32": ("lsa_epilogue", [_P] * 4 + [_I] * 8 + [_P]),
    "lsa_epilogue_bf16": ("lsa_epilogue", [_P] * 4 + [_I] * 8 + [_P]),
    "bias_add_f32": ("bias_add", [_P, _P, _L, _I, _L, _P]),
    "bias_add_bf16": ("bias_add", [_P, _P, _L, _I, _L, _P]),
}
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the entry points' dtype suffixes

# {counted name: launches since the last reset}, which ops.launches() shows
LAUNCHES = dict.fromkeys((
    "pooled_attention", "conv3x3_bn_relu", "dfc_tail", "fused_mha", "fused_mha_sep", "conv3x3_bias_stats",
    "probe_matmul", "probe_conv_cat", "probe_conv_9dot", "conv3x3_s8", "lsa_epilogue", "bias_add",
    "pooled_attention.fewer_queries", "pooled_attention.more_queries"), 0)

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


def launches() -> dict:
    """{kernel name: launches since the last reset}, and two parts of the pooled attention's own:
    ``pooled_attention.fewer_queries`` and ``pooled_attention.more_queries``, its launches with fewer
    queries than keys (a band's) and with more (SegFormer's)."""
    return dict(LAUNCHES)


def reset_launches() -> None:
    """Set every count of ``launches()`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(entry: str, counted: tuple, device, *args) -> None:
    """Launch the C function ``entry`` of SIGNATURES on ``args`` and ``device``'s current stream, raise
    where it returns an error, and count the launch under each name of ``counted`` in LAUNCHES."""
    err = kernel(entry)(*args, stream_handle(device))
    if err:
        check(err, entry)
    for name in counted:
        LAUNCHES[name] += 1


def on_cpu(*tensors) -> bool:
    """Whether every tensor given (None: a halo row not given) lies on the CPU, where a wrapper runs its
    plain version; a wrapper given tensors elsewhere launches its kernel or raises, it never falls back."""
    for t in tensors:
        if t is not None and t.device.type != "cpu":
            return False
    return True


def check_operands(name: str, operands, contiguous: bool = True, aligned: bool = False, no_grad=()) -> None:
    """Raise unless kernel ``name`` takes ``operands``, (label, tensor, dtype) triples checked one after
    another: each on the CUDA device of the first (ValueError), of its dtype (TypeError; None: the
    compute dtype, the first operand's, f32 or bf16), contiguous where ``contiguous`` and starting
    16-byte aligned where ``aligned`` (ValueError).  Then NotImplementedError where grad is enabled and
    a tensor of ``no_grad`` requires it: those kernels have no backward."""
    label0, first, dtype0 = operands[0]
    dev, compute = first.device, first.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: {label0} is on {dev}; the kernel takes CUDA tensors")
    if dtype0 is None and compute not in SUFFIX:
        raise TypeError(f"{name}: {label0} is {compute}; the kernel takes f32 or bf16")
    for label, t, dtype in operands:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, {label0} on {dev}")
        if t.dtype != (compute if dtype is None else dtype):
            raise TypeError(f"{name}: {label} is {t.dtype}, must be {compute if dtype is None else dtype}")
        if contiguous and not t.is_contiguous() or aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous{' and 16-byte aligned' if aligned else ''}")
    if no_grad and torch.is_grad_enabled():
        for t in no_grad:
            if t.requires_grad:
                raise NotImplementedError(f"{name}: the kernel is forward-only, it has no backward")


def plain_vjp(plain, inputs, grad_out):
    """Gradients of ``plain(*inputs)`` w.r.t. the inputs that need one, for the backward of a kernel's
    autograd Function: the forward is recomputed through the plain version on detached copies, so
    nothing but the inputs was saved.  Gradients come back contiguous, in the inputs' layout."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        out = plain(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads).contiguous() if t.requires_grad else None for t in leaves)


class PlainBackward(torch.autograd.Function):
    """``apply(launch_fn, plain, args, *tensors)``: ``launch_fn(*tensors, *args)`` forward (the kernel);
    backward, the gradients of ``plain(*tensors, *args)`` through ``plain_vjp``, which is what the JAX
    custom VJPs do: no kernel has a backward."""

    @staticmethod
    def forward(ctx, launch_fn, plain, args, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.plain, ctx.args = plain, args
        return launch_fn(*tensors, *args)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None, None,
                *plain_vjp(lambda *t: ctx.plain(*t, *ctx.args), ctx.saved_tensors, grad_out))


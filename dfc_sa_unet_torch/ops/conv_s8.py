"""Int8 products of the int8 serving engines: the 3x3 conv kernel and the s8 matmul.

``conv3x3_s8`` is the counterpart of the JAX int8 engine's quantized 3x3 conv,
an s8 x s8 -> s32 XLA convolution with its dequant epilogue after it
(dfc_sa_unet_tpu/infer/quant.py:240-246 and :286-290), which has no Pallas
kernel: PyTorch has no int8 convolution on CUDA, so the card runs the
hand-written csrc/conv3x3_s8.cu.  It computes

    out = ReLU(f32(conv3x3(x8, w8), summed in s32) * scale + b), cast once to ``out_dtype``

with x8 s8 NHWC [B,H,W,Cin] (padding 1), w8 s8 [Cout, 9 * Cin] (K-major:
column tap * Cin + c for tap (dy+1)*3 + (dx+1); ``pack_s8_taps`` makes it from
an OIHW weight), scale = f32(sx) * s_w and b f32 [Cout].  The wrapper runs the
plain version on CPU tensors and launches the kernel (or raises) on CUDA
tensors; the kernel takes Cin a multiple of 16, which the wrapper zero-pads,
and Cout a multiple of 8.  Kernel and plain version agree bit for bit: the s32
sums are exact and the epilogue is the same f32 multiply, add and ReLU in the
same order.

``s8_matmul`` is the s8 product of the 1x1 convs and the linears:
``torch._int_mm`` (s8 x s8 -> s32, the s8 counterpart of ``torch.matmul``,
as JAX left these products to XLA) and the f32 epilogue in torch.  Its
operands are zero-padded to what ``_int_mm`` takes on CUDA (more than 16
rows, K and N multiples of 8) on every device.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

CIN_MULTIPLE = 16  # the kernel's 16-byte chunks of x: a chunk never straddles two taps
BLOCK_PIXELS = 128  # pixels a block: wgconv::kBM of csrc/conv3x3_wgmma.cuh
_OUT = {torch.bfloat16: "bf16", torch.float32: "f32"}

LAUNCHES = {"conv3x3_s8": 0}


def s8_tiling(cout: int) -> int:
    """The B tile's width of csrc/conv3x3_s8.cu (its dispatch instantiates 64, 128 and 256)."""
    return 64 if cout <= 64 else 128 if cout <= 128 else 256


def pack_s8_taps(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> [Cout, 9 * Cin], column tap * Cin + c (the kernel's K walk)."""
    cout, cin = w_oihw.shape[:2]
    return w_oihw.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()


def _pad_cin(x8, w8, multiple):
    """x8 [B,H,W,Cin] and w8 [Cout, 9 * Cin] with Cin zero-padded to a multiple of ``multiple``."""
    pad = -x8.shape[-1] % multiple
    if not pad:
        return x8, w8
    cout, cin = w8.shape[0], x8.shape[-1]
    return F.pad(x8, (0, pad)), F.pad(w8.view(cout, 9, cin), (0, pad)).reshape(cout, 9 * (cin + pad))


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w [N, K]^T in s32, exact.  Both are zero-padded to _int_mm's CUDA rules (M > 16, K and
    N multiples of 8); w goes in as the transposed view of its row-major [N, K], the one layout of the
    second operand that cuBLASLt's s8 product takes (row-major [K, N] is refused)."""
    m, k = a.shape
    n = w.shape[0]
    pad_m, pad_k, pad_n = max(0, 17 - m), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if pad_m or pad_n else out


def s8_matmul_s32(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [..., K] s8 @ w8 [N, K]^T s8 -> [..., N] s32 (exact)."""
    return _int_mm(x8.reshape(-1, x8.shape[-1]), w8).reshape(*x8.shape[:-1], w8.shape[0])


def s8_matmul(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, bias=None) -> torch.Tensor:
    """f32(x8 @ w8^T, summed in s32) * scale (+ bias): x8 [..., K] s8, w8 [N, K] s8 (a 1x1 conv's or a
    linear's weight in torch's layout), scale and bias f32 [N] -> f32 [..., N].  The epilogue of
    quant.py's products: the scale vector (f32(sx) * s_w) is formed by the caller, the bias added after
    the multiply."""
    y = s8_matmul_s32(x8, w8).float() * scale
    return y if bias is None else y + bias


def im2col_s8(x8: torch.Tensor) -> torch.Tensor:
    """[B,H,W,Cin] s8 -> [B*H*W, 9 * Cin]: the nine shifted views (zero padding 1), tap-major."""
    b, h, w, cin = x8.shape
    xp = F.pad(x8, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(b * h * w, 9 * cin)


def conv3x3_s8_s32(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The s32 3x3 conv (zero padding 1) of x8 [B,H,W,Cin] with w8 [Cout, 9 * Cin]: _int_mm on the
    [P, 9 * Cin] taps -> [B,H,W,Cout] s32, exact."""
    bsz, h, w, _ = x8.shape
    x8, w8 = _pad_cin(x8, w8, CIN_MULTIPLE)
    return _int_mm(im2col_s8(x8), w8).reshape(bsz, h, w, w8.shape[0])


def conv3x3_s8_plain(x8, w8, scale, b, out_dtype=torch.bfloat16):
    """The kernel's function in torch ops: the s32 product, then ReLU(acc.float() * scale + b) and
    one cast."""
    return torch.relu(conv3x3_s8_s32(x8, w8).float() * scale + b).to(out_dtype)


def _check(x8, w8, scale, b, out_dtype):
    dev = x8.device
    if x8.dim() != 4 or w8.dim() != 2:
        raise ValueError(f"conv3x3_s8: x8 {tuple(x8.shape)} must be NHWC, w8 {tuple(w8.shape)} [Cout, 9 * Cin]")
    cin, cout = x8.shape[-1], w8.shape[0]
    if tuple(w8.shape) != (cout, 9 * cin) or tuple(scale.shape) != (cout,) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3_s8: shapes x8 {tuple(x8.shape)}, w8 {tuple(w8.shape)}, scale "
                         f"{tuple(scale.shape)}, b {tuple(b.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"conv3x3_s8: x8 is on {dev}; the kernel takes CUDA tensors")
    for label, t, want in (("x8", x8, torch.int8), ("w8", w8, torch.int8), ("scale", scale, torch.float32),
                           ("b", b, torch.float32)):
        if t.device != dev:
            raise ValueError(f"conv3x3_s8: {label} is on {t.device}, x8 on {dev}")
        if t.dtype != want:
            raise TypeError(f"conv3x3_s8: {label} is {t.dtype}, must be {want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3x3_s8: {label} must be contiguous and 16-byte aligned")
    if out_dtype not in _OUT:
        raise TypeError(f"conv3x3_s8: out_dtype {out_dtype}; the kernel writes bf16 or f32")
    if cout % 8:
        raise ValueError(f"conv3x3_s8: Cout={cout} not supported by the kernel (a multiple of 8)")
    if x8.shape[0] * x8.shape[1] * x8.shape[2] >= 2**31:
        raise ValueError("conv3x3_s8: the pixels exceed the kernel's int32 pixel index")


def conv3x3_s8(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """x8 [B,H,W,Cin] s8; w8 [Cout, 9*Cin] s8; scale, b [Cout] f32 -> [B,H,W,Cout] ``out_dtype``."""
    if all(t.device.type == "cpu" for t in (x8, w8, scale, b)):
        return conv3x3_s8_plain(x8, w8, scale, b, out_dtype)
    _check(x8, w8, scale, b, out_dtype)
    bsz, h, width, _ = x8.shape
    cout = w8.shape[0]
    out = torch.empty((bsz, h, width, cout), dtype=out_dtype, device=x8.device)
    if out.numel():
        x8, w8 = _pad_cin(x8, w8, CIN_MULTIPLE)
        name = f"conv3x3_s8_{_OUT[out_dtype]}"
        err = _build.kernel(name)(x8.data_ptr(), w8.data_ptr(), scale.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  bsz * h * width, h, width, x8.shape[-1], cout, s8_tiling(cout),
                                  _build.stream_handle(x8.device))
        _build.check(err, name)
        LAUNCHES["conv3x3_s8"] += 1
    return out

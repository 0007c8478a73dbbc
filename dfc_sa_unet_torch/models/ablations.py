"""The four ablation families (8 model names) over the shared skeleton
(counterpart of dfc_sa_unet_tpu/models/ablations.py).

Reference files:
  1. branches   - models/unet_dfc_sa_ablation_branches.py  (UNet_Baseline,
     UNet_AttentionOnly)
  2. fusion     - models/unet_dfc_sa_ablation_fusion.py    (UNet_AdditionFusion,
     UNet_ConcatFusion)
  3. attention  - models/unet_dfc_sa_ablation_attention.py (UNet_FullResAttention)
  4. placement  - models/unet_dfc_sa_ablation_placement.py (UNet_EncoderOnlyDFC,
     UNet_DecoderOnlyDFC, UNet_BothStandardConv)

Each class names an encoder and a decoder block kind; the bottleneck
follows the encoder's.  The ablations' DFC blocks fix the QK reduction at
C//8 whatever ``ablation_on_qk_channels`` says, and no ablation takes
``remat`` (ablations.py:66,71,80-88).  Every attention-bearing kind runs
the attention kernel on the card, the full-resolution one included: with
H*W tokens per image it takes inputs up to 64x64 (N = 4096) and the
wrapper raises above.
"""

from functools import partial

from torch import nn

from dfc_sa_unet_torch.models.blocks import (AdditionFusionBlock, AttentionOnlyBlock, ConcatFusionBlock, DFCBlock,
                                             LocalOnlyBlock, build_unet, unet_forward)


def _block_factory(kind, pool_size, compute_dtype):
    if kind == "local":
        return partial(LocalOnlyBlock, compute_dtype=compute_dtype)
    if kind == "attention":
        return partial(AttentionOnlyBlock, pool_size=pool_size, compute_dtype=compute_dtype)
    if kind == "addition":
        return partial(AdditionFusionBlock, pool_size=pool_size, compute_dtype=compute_dtype)
    if kind == "concat":
        return partial(ConcatFusionBlock, pool_size=pool_size, compute_dtype=compute_dtype)
    if kind == "dfc":
        return partial(DFCBlock, pool_size=pool_size, qk_div=8, compute_dtype=compute_dtype)
    if kind == "dfc_fullres":
        return partial(DFCBlock, qk_div=8, full_res=True, compute_dtype=compute_dtype)
    raise ValueError(f"unknown block kind: {kind}")


class AblationUNet(nn.Module):
    """Base: a U-Net with independently chosen encoder and decoder block kinds."""

    enc_kind = "local"
    dec_kind = "local"

    def __init__(self, in_channels=3, out_channels=1, features=(64, 128, 256, 512), pool_size=8,
                 compute_dtype=None):
        super().__init__()
        build_unet(self, in_channels, out_channels, features,
                   _block_factory(self.enc_kind, pool_size, compute_dtype),
                   _block_factory(self.dec_kind, pool_size, compute_dtype), compute_dtype)

    def forward(self, x):
        return unet_forward(self, x)


class UNetBaseline(AblationUNet):
    """Ablation 1(b): local-only blocks everywhere."""


class UNetAttentionOnly(AblationUNet):
    """Ablation 1(a): attention-only blocks everywhere."""
    enc_kind = dec_kind = "attention"


class UNetAdditionFusion(AblationUNet):
    """Ablation 2(a): local+attn addition fusion everywhere."""
    enc_kind = dec_kind = "addition"


class UNetConcatFusion(AblationUNet):
    """Ablation 2(b): concat + 1x1 fusion everywhere."""
    enc_kind = dec_kind = "concat"


class UNetFullResAttention(AblationUNet):
    """Ablation 3: DFC blocks with full-resolution attention everywhere."""
    enc_kind = dec_kind = "dfc_fullres"


class UNetEncoderOnlyDFC(AblationUNet):
    """Ablation 4(a): DFC encoder+bottleneck, local-only decoder."""
    enc_kind = "dfc"


class UNetDecoderOnlyDFC(AblationUNet):
    """Ablation 4(b): local-only encoder+bottleneck, DFC decoder."""
    dec_kind = "dfc"


class UNetBothStandardConv(AblationUNet):
    """Ablation 4(c): local-only everywhere (the same as the baseline; kept
    as a distinct factory name for config parity)."""


ABLATIONS = {
    "UNet_Baseline": UNetBaseline,
    "UNet_AttentionOnly": UNetAttentionOnly,
    "UNet_AdditionFusion": UNetAdditionFusion,
    "UNet_ConcatFusion": UNetConcatFusion,
    "UNet_FullResAttention": UNetFullResAttention,
    "UNet_EncoderOnlyDFC": UNetEncoderOnlyDFC,
    "UNet_DecoderOnlyDFC": UNetDecoderOnlyDFC,
    "UNet_BothStandardConv": UNetBothStandardConv,
}

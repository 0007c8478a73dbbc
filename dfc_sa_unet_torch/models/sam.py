"""Segment Anything (Kirillov et al., "Segment Anything", ICCV 2023, arXiv:2304.02643), ViT-B, served
with one box prompt an image: the image encoder, the prompt encoder and the mask decoder of
github.com/facebookresearch/segment-anything (``segment_anything/modeling/{image_encoder,
prompt_encoder,mask_decoder,transformer,common}.py``), at the widths of ``build_sam.py::
build_sam_vit_b``.  MedSAM (Ma et al., Nature Communications 15:654, 2024) is this model fine-tuned
on medical images and served the same way, one box a 1024x1024 image.  The factory's name is
``SAM``; its defaults are ViT-B's (``VIT_B``).  This model has no counterpart in the JAX package.

* Image encoder: a 16x16 patch conv to 768 channels (64x64 tokens at 1024x1024), a learned absolute
  position embedding, 12 blocks of x + attn(norm1(x)) and x + mlp(norm2(x)) (LayerNorm eps 1e-6; the
  MLP lin1 to 3072, the exact GELU, lin2), 12 heads of 64 with a qkv bias and the decomposed relative
  position of every block (``rel_pos_h``, ``rel_pos_w``: 2 S - 1 rows of 64 a side S).  Blocks 2, 5,
  8 and 11 attend over the whole 64x64 map; the others over 14x14 windows of the map zero-padded to
  70x70 (25 windows an image), whose padded tokens are not masked: they enter as the qkv bias, as
  the source applies ``qkv`` after the padding.  The neck: a 1x1 conv to 256, LayerNorm2d, a 3x3
  conv, LayerNorm2d (eps 1e-6, no biases in the convs).
* Prompt encoder: each box's corners (+ 0.5, over the input size) through the random-Fourier
  position encoding plus ``point_embeddings[2]`` and ``[3]``: two sparse tokens; the dense
  embedding ``no_mask_embed`` at every position; the image's positional encoding from the same
  Gaussian matrix.
* Mask decoder: the IoU token and 4 mask tokens before the box's two; a two-way transformer (depth
  2, width 256, 8 heads, MLP 2048 with ReLU, the cross attentions at half width, LayerNorm eps 1e-5,
  the first layer's self-attention without the tokens' position); two 2x transposed convs to
  256x256 (LayerNorm2d and GELU between, GELU after); mask 0's hypernetwork MLP against them
  (``multimask_output=False``); the 256x256 logits resized bilinearly to the input's size, as
  ``Sam.postprocess_masks`` does for an unpadded 1024x1024 image.

State-dict keys are the source's throughout (``image_encoder.*``, ``prompt_encoder.*``,
``mask_decoder.*``), so a published SAM or MedSAM checkpoint loads strict.  The served forward does
not call ``prompt_encoder.mask_downscaling`` (no mask prompt), the hypernetworks of masks 1-3 or
the IoU head: it returns a mask, not a score.

Departures from the source, all of them:
* the encoder's attention is the pooled-attention kernel with the decomposed bias inside it
  (``ops/pooled_attention.py``, ``rel_h`` / ``rel_w``): q, k and v read where they lie in the qkv
  output; the 1 / sqrt(head dim) scale folded into q's third of ``qkv`` (exact at heads of 64, a
  power of two) and the tables computed from the scaled q against the gathered ``get_rel_pos`` rows
  times sqrt(head dim), so that each product is the source's q . R with q unscaled; energies and
  softmax in f32, the bias added (rel_h, then rel_w) before the softmax, as the source adds it;
* the tables must have the length of the attention's side (no resize of ``rel_pos`` as
  ``get_rel_pos`` does for a checkpoint of another input size), and the input is ``img_dim`` square;
* the decoder's attentions (7 tokens) are torch ops with the softmax in f32;
* the inputs' normalisation is the serving path's: ImageNet's mean and std over x / 255, which is
  the source's ``pixel_mean`` and ``pixel_std`` over x;
* ``forward(x, boxes=None)`` takes one box an image ([B, 4] as x0, y0, x1, y1 in input pixels) or,
  without one, the configuration's ``box`` for every image.

Takes normalised NCHW images (stored channels_last) of ``img_dim`` x ``img_dim`` and returns [B,1,H,W]
logits in the compute dtype.  Row sharding (parallel/rows.py) raises: the global layers span the
image.  Under a ``torch.profiler`` session the forward's parts are timed spans
(``utils/profiling.py``): ``sam.window_attention`` and ``sam.global_attention`` (each block's first
residual branch: the norm, the pad and partition, qkv, the tables, the kernel, proj, the unpartition
and the add), ``sam.mlp`` (the second) and ``sam.decoder`` (the neck, the prompt encoder, the mask
decoder and the resize of the logits).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.models.vit_seg import gelu
from dfc_sa_unet_torch.nn.layers import Conv, ConvTranspose2x2, Dense, LayerNorm, add_bias_
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.profiling import span

# build_sam.py::build_sam_vit_b (through _build_sam): the image encoder, the prompt encoder and the mask decoder
VIT_B = {"img_size": 1024, "patch_size": 16, "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4,
         "global_attn_indexes": (2, 5, 8, 11), "window_size": 14, "out_chans": 256, "mask_in_chans": 16,
         "decoder_depth": 2, "decoder_heads": 8, "decoder_mlp_dim": 2048, "num_multimask_outputs": 3,
         "iou_head_depth": 3, "iou_head_hidden_dim": 256, "box": (0, 0, 1023, 1023)}
ENCODER_EPS = 1e-6  # norm_layer=partial(torch.nn.LayerNorm, eps=1e-6), and LayerNorm2d's


class LayerNorm2d(LayerNorm):
    """common.py's LayerNorm2d: each pixel's channels of an NCHW map normalised (eps 1e-6), through the
    port's LayerNorm on the channels-last rows."""

    def __init__(self, channels, eps=ENCODER_EPS):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)


class _QKV(Dense):
    """The attention's qkv layer with q's third times ``scale`` folded into its weight and bias."""

    def __init__(self, dim, scale, compute_dtype=None):
        super().__init__(dim, 3 * dim, compute_dtype=compute_dtype)
        self.register_buffer("scale", torch.cat([torch.full((dim,), scale), torch.ones(2 * dim)]), persistent=False)

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        return add_bias_(F.linear(x.to(dtype), (self.weight * self.scale[:, None]).to(dtype)), self.bias * self.scale)


def rel_pos_rows(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """image_encoder.py::get_rel_pos for queries and keys on one side of ``size``: [size, size, C], row
    (i, j) the table's row of the offset i - j."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} rows for a side of {size}: the port "
                         f"takes 2 x {size} - 1 rows (it does not resize a table of another input size)")
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


class _Attention(nn.Module):
    """image_encoder.py's Attention with ``use_rel_pos``, on [B, h, w, C] (a window or the whole map):
    softmax(q k^T / sqrt(hd) + rel_h + rel_w) v through the pooled-attention kernel, then proj."""

    def __init__(self, dim, num_heads, size, compute_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.head_dim = head_dim
        self.qkv = _QKV(dim, head_dim ** -0.5, compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x):
        b, h, w, c = x.shape
        heads, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x.reshape(b, h * w, c))  # [b, N, 3C]: q (scaled), k, v, each heads x hd
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        # the tables from the scaled q against R sqrt(hd): the source's q . R with q unscaled
        q5 = q.unflatten(-1, (heads, hd)).unflatten(1, (h, w))  # [b, h, w, heads, hd]
        unscale = hd ** 0.5
        rh = rel_pos_rows(h, self.rel_pos_h * unscale).to(q.dtype)
        rw = rel_pos_rows(w, self.rel_pos_w * unscale).to(q.dtype)
        rel_h = torch.einsum("bhwnc,hkc->bhwnk", q5, rh).reshape(b, h * w, heads, h).contiguous()
        rel_w = torch.einsum("bhwnc,wkc->bhwnk", q5, rw).reshape(b, h * w, heads, w).contiguous()
        return self.proj(pooled_attention(q, k, v, heads, rel_h, rel_w)).reshape(b, h, w, c)


class _MLPBlock(nn.Module):
    """common.py's MLPBlock: lin1, the activation, lin2."""

    def __init__(self, dim, mlp_dim, act=gelu, compute_dtype=None):
        super().__init__()
        self.lin1 = Dense(dim, mlp_dim, compute_dtype=compute_dtype)
        self.lin2 = Dense(mlp_dim, dim, compute_dtype=compute_dtype)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class _Block(nn.Module):
    """An encoder block on the [B, H, W, C] map: windowed (``window_size`` > 0) or global."""

    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size, compute_dtype=None):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=ENCODER_EPS)
        self.attn = _Attention(dim, num_heads, window_size or input_size, compute_dtype)
        self.norm2 = LayerNorm(dim, eps=ENCODER_EPS)
        self.mlp = _MLPBlock(dim, dim * mlp_ratio, compute_dtype=compute_dtype)

    def _windows(self, x):
        """window_partition and attention and window_unpartition: the map zero-padded to whole windows, the
        attention over each window's tokens (padding included, unmasked), the padding cropped."""
        b, h, w, c = x.shape
        ws = self.window_size
        ph, pw = -h % ws, -w % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
        y = self.attn(x).view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        return y[:, :h, :w] if ph or pw else y

    def forward(self, x):
        with span("sam.window_attention" if self.window_size else "sam.global_attention", timed=True):
            y = self.norm1(x)
            x = x + (self._windows(y) if self.window_size else self.attn(y))
        with span("sam.mlp", timed=True):
            return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size, patch_size, in_chans, embed_dim, depth, num_heads, mlp_ratio, out_chans,
                 window_size, global_attn_indexes, compute_dtype=None):
        super().__init__()
        self.img_size, grid = img_size, img_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(in_chans, embed_dim, patch_size, stride=patch_size, compute_dtype=compute_dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, 0 if i in global_attn_indexes else window_size, grid,
                   compute_dtype) for i in range(depth))
        self.neck = nn.Sequential(Conv(embed_dim, out_chans, 1, bias=False, compute_dtype=compute_dtype),
                                  LayerNorm2d(out_chans),
                                  Conv(out_chans, out_chans, 3, padding=1, bias=False, compute_dtype=compute_dtype),
                                  LayerNorm2d(out_chans))

    def trunk(self, x):
        """NCHW images -> the blocks' [B, H/16, W/16, C] map."""
        y = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        y = (y.float() + self.pos_embed).to(y.dtype)  # the f32 sum rounded once
        for block in self.blocks:
            y = block(y)
        return y

    def forward(self, x):
        return self.neck(self.trunk(x).permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    """prompt_encoder.py's random-Fourier position encoding; its Gaussian matrix is a buffer of the state
    dict."""

    def __init__(self, num_pos_feats=64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, num_pos_feats)))

    def _pe_encoding(self, coords):
        coords = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size):
        """[C, h, w] of the map's cell centres."""
        h, w = size
        grid = torch.ones((h, w), device=self.positional_encoding_gaussian_matrix.device, dtype=torch.float32)
        y = (grid.cumsum(dim=0) - 0.5) / h
        x = (grid.cumsum(dim=1) - 0.5) / w
        return self._pe_encoding(torch.stack([x, y], dim=-1)).permute(2, 0, 1)

    def forward_with_coords(self, coords, image_size):
        coords = torch.stack([coords[..., 0] / image_size[1], coords[..., 1] / image_size[0]], dim=-1)
        return self._pe_encoding(coords.float())


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim, image_embedding_size, input_image_size, mask_in_chans):
        super().__init__()
        self.embed_dim, self.input_image_size = embed_dim, input_image_size
        self.image_embedding_size = image_embedding_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        # the mask prompt's path: in the state dict, not called by a box prompt
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, kernel_size=2, stride=2), LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, kernel_size=2, stride=2), LayerNorm2d(mask_in_chans),
            nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, kernel_size=1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self):
        return self.pe_layer(self.image_embedding_size).unsqueeze(0)

    def forward(self, boxes):
        """[B, 4] boxes -> (sparse [B, 2, C], dense [B, C, h, w]) in f32."""
        corners = self.pe_layer.forward_with_coords((boxes.float() + 0.5).reshape(-1, 2, 2), self.input_image_size)
        sparse = torch.stack([corners[:, 0] + self.point_embeddings[2].weight[0],
                              corners[:, 1] + self.point_embeddings[3].weight[0]], dim=1)
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(boxes.shape[0], -1,
                                                                     *self.image_embedding_size)
        return sparse, dense


class _TokenAttention(nn.Module):
    """transformer.py's Attention: projections (to dim / downsample_rate), heads, softmax(q k^T / sqrt(c)) v in
    f32, the output projection."""

    def __init__(self, dim, num_heads, downsample_rate=1, compute_dtype=None):
        super().__init__()
        internal = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Dense(dim, internal, compute_dtype=compute_dtype)
        self.k_proj = Dense(dim, internal, compute_dtype=compute_dtype)
        self.v_proj = Dense(dim, internal, compute_dtype=compute_dtype)
        self.out_proj = Dense(internal, dim, compute_dtype=compute_dtype)

    def forward(self, q, k, v):
        def heads(t):
            return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

        q, k, v = heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v))
        attn = torch.softmax((q @ k.transpose(-2, -1)).float() / math.sqrt(q.shape[-1]), dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).flatten(-2)
        return self.out_proj(out)


class _TwoWayBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, skip_first_layer_pe, compute_dtype=None):
        super().__init__()
        self.self_attn = _TokenAttention(dim, num_heads, compute_dtype=compute_dtype)
        self.norm1 = LayerNorm(dim)
        self.cross_attn_token_to_image = _TokenAttention(dim, num_heads, 2, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = _MLPBlock(dim, mlp_dim, F.relu, compute_dtype)
        self.norm3 = LayerNorm(dim)
        self.norm4 = LayerNorm(dim)
        self.cross_attn_image_to_token = _TokenAttention(dim, num_heads, 2, compute_dtype)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth, dim, num_heads, mlp_dim, compute_dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(_TwoWayBlock(dim, num_heads, mlp_dim, i == 0, compute_dtype) for i in range(depth))
        self.final_attn_token_to_image = _TokenAttention(dim, num_heads, 2, compute_dtype)
        self.norm_final_attn = LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        attn = self.final_attn_token_to_image(queries + point_embedding, keys + key_pe, keys)
        return self.norm_final_attn(queries + attn), keys


class _MLP(nn.Module):
    """mask_decoder.py's MLP: ``num_layers`` linear layers, ReLU between."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, compute_dtype=None):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(Dense(n, k, compute_dtype=compute_dtype)
                                    for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim, depth, num_heads, mlp_dim, num_multimask_outputs, iou_head_depth, iou_head_hidden_dim,
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.transformer = TwoWayTransformer(depth, dim, num_heads, mlp_dim, compute_dtype)
        self.iou_token = nn.Embedding(1, dim)
        self.num_mask_tokens = num_multimask_outputs + 1
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(ConvTranspose2x2(dim, dim // 4, compute_dtype), LayerNorm2d(dim // 4),
                                              nn.GELU(), ConvTranspose2x2(dim // 4, dim // 8, compute_dtype), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(_MLP(dim, dim, dim // 8, 3, compute_dtype)
                                                       for _ in range(self.num_mask_tokens))
        # the IoU head: in the state dict, not called (the served forward returns a mask, not a score)
        self.iou_prediction_head = _MLP(dim, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth, compute_dtype)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """Mask 0's logits [B, 1, 4h, 4w] (``multimask_output=False``)."""
        dtype = image_embeddings.dtype
        b = sparse.shape[0]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0).unsqueeze(0).expand(b, -1, -1)
        tokens = torch.cat([tokens, sparse], dim=1).to(dtype)
        src = (image_embeddings.float() + dense).to(dtype)
        hs, src = self.transformer(src, image_pe.to(dtype).expand(b, -1, -1, -1), tokens)
        _, c, h, w = image_embeddings.shape
        up = self.output_upscaling[0](src.transpose(1, 2).reshape(b, c, h, w))
        up = gelu(self.output_upscaling[1](up))
        up = gelu(self.output_upscaling[3](up))
        hyper = self.output_hypernetworks_mlps[0](hs[:, 1])  # mask 0's token
        _, cu, hu, wu = up.shape
        return (hyper.unsqueeze(1) @ up.reshape(b, cu, hu * wu)).reshape(b, 1, hu, wu)


class SAM(nn.Module):
    """Factory name 'SAM'."""

    def __init__(self, in_channels=3, img_size=VIT_B["img_size"], patch_size=VIT_B["patch_size"],
                 embed_dim=VIT_B["embed_dim"], depth=VIT_B["depth"], num_heads=VIT_B["num_heads"],
                 mlp_ratio=VIT_B["mlp_ratio"], global_attn_indexes=VIT_B["global_attn_indexes"],
                 window_size=VIT_B["window_size"], out_chans=VIT_B["out_chans"], mask_in_chans=VIT_B["mask_in_chans"],
                 decoder_depth=VIT_B["decoder_depth"], decoder_heads=VIT_B["decoder_heads"],
                 decoder_mlp_dim=VIT_B["decoder_mlp_dim"], num_multimask_outputs=VIT_B["num_multimask_outputs"],
                 iou_head_depth=VIT_B["iou_head_depth"], iou_head_hidden_dim=VIT_B["iou_head_hidden_dim"],
                 box=VIT_B["box"], compute_dtype=None):
        super().__init__()
        self.img_dim = img_size
        grid = img_size // patch_size
        self.image_encoder = ImageEncoderViT(img_size, patch_size, in_channels, embed_dim, depth, num_heads, mlp_ratio,
                                             out_chans, window_size, tuple(global_attn_indexes), compute_dtype)
        self.prompt_encoder = PromptEncoder(out_chans, (grid, grid), (img_size, img_size), mask_in_chans)
        self.mask_decoder = MaskDecoder(out_chans, decoder_depth, decoder_heads, decoder_mlp_dim, num_multimask_outputs,
                                        iou_head_depth, iou_head_hidden_dim, compute_dtype)
        self.register_buffer("box", torch.tensor(box, dtype=torch.float32), persistent=False)

    def forward(self, x, boxes=None):
        if rows.current() is not None:
            raise rows.unported("SAM, whose global attention spans the image")
        if tuple(x.shape[2:]) != (self.img_dim, self.img_dim):
            raise ValueError(f"SAM takes {self.img_dim}x{self.img_dim} inputs, not {tuple(x.shape[2:])}")
        y = self.image_encoder.trunk(x)
        with span("sam.decoder", timed=True):
            emb = self.image_encoder.neck(y.permute(0, 3, 1, 2))
            boxes = self.box.expand(x.shape[0], 4) if boxes is None else boxes.to(x.device)
            sparse, dense = self.prompt_encoder(boxes)
            low = self.mask_decoder(emb, self.prompt_encoder.get_dense_pe(), sparse, dense)
            return resize_bilinear(low, x.shape[2:])

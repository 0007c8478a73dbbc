"""Plain float32 reference of Segment Anything ViT-B (Kirillov et al., arXiv:2304.02643;
github.com/facebookresearch/segment-anything, ``segment_anything/build_sam.py::build_sam_vit_b`` and
``segment_anything/modeling/{image_encoder,prompt_encoder,mask_decoder,transformer,common}.py``), the
model MedSAM serves, written over a state dict with that code's keys, for serving one box an image
(``Sam.forward`` with ``multimask_output=False``).

* Image encoder (``ImageEncoderViT``): a 16x16 patch conv to 768 channels, the absolute position
  embedding added, 12 blocks of width 768, 12 heads, MLP 3072 (exact GELU), LayerNorm eps 1e-6, a qkv
  bias, ``use_rel_pos``; blocks 2, 5, 8 and 11 global over the 64x64 map, the others over 14x14
  windows of the map zero-padded to 70x70 (``window_partition`` / ``window_unpartition``, padding not
  masked); the attention ``(q * scale) @ k^T``, ``add_decomposed_rel_pos`` with ``get_rel_pos`` on
  the materialised energies, softmax, ``@ v``, ``proj``; the neck: 1x1 conv to 256, LayerNorm2d, 3x3
  conv, LayerNorm2d (eps 1e-6, no conv biases).
* Prompt encoder (``PromptEncoder``): the box's corners + 0.5 over the input size through
  ``PositionEmbeddingRandom``, plus ``point_embeddings[2]`` and ``[3]``; ``no_mask_embed`` as the
  dense embedding; the image's positional encoding.
* Mask decoder (``MaskDecoder`` with ``TwoWayTransformer``: depth 2, width 256, 8 heads, MLP 2048,
  ReLU, the cross attentions at half width, LayerNorm eps 1e-5): the IoU and 4 mask tokens before
  the box's two, two 2x transposed convs (LayerNorm2d, GELU; GELU), the hypernetwork MLPs, the masks'
  product; mask 0 (single-mask output); ``Sam.postprocess_masks``: bilinear (align_corners=False)
  to the encoder's 1024, cropped to the input, resized to the input's size.

Departures from the source, all of them:
* the box is the configuration's ``box`` for every image (the source takes prompts per image);
* the inputs' normalisation and padding are the serving path's: it takes normalised images of the
  encoder's size (ImageNet's mean and std over x / 255, the source's ``pixel_mean`` / ``pixel_std``);
* the attention is computed for at most ``ATTENTION_BLOCK`` images at a time (the same values; it
  bounds the materialised 4096 x 4096 energies of the global blocks);
* the IoU head is not run (its score is not compared).

Nothing of the program under test is imported: plain ``torch`` only.  The check computes it inside
``reference.plain.exact_f32`` (no TF32); ``precision`` rounds every product's operands
(``reference.plain.Precision``), the relative-position einsums' too.
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference.plain import Precision

WIDTHS = {"img_size": 1024, "patch_size": 16, "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4,
          "global_attn_indexes": (2, 5, 8, 11), "window_size": 14, "out_chans": 256, "mask_in_chans": 16,
          "decoder_depth": 2, "decoder_heads": 8, "decoder_mlp_dim": 2048, "num_multimask_outputs": 3,
          "iou_head_depth": 3, "iou_head_hidden_dim": 256, "box": (0, 0, 1023, 1023)}
ATTENTION_BLOCK = 4
# the gain of the qkv draw: q and k twice a variance-preserving draw's, so that the scaled energies q . k / sqrt(hd)
# spread about 4 and the attention picks keys (a row's largest weight ~0.3-0.4 at the global blocks), as a trained
# encoder's does; at gain 1 they spread about 1, the weights are near uniform and the bias hardly moves the output
QKV_GAIN = 4.0
# the spread of the drawn relative-position tables times sqrt(head dim): q . R over hd channels of q has a spread
# of this times |q|'s, each table about half that of the scaled energies (2 against 4 at the global blocks)
REL_POS_SPREAD = 1.0


def _widths(m):
    return {key: m.get(key, default) for key, default in WIDTHS.items()}


def state_spec(config) -> dict:
    """{key: (shape, draw)} of every parameter and buffer of the source's state dict (the draws of
    dfc_sa_res_block.state_spec): convolutions and linear layers a variance-preserving spread (2 / fan-in
    before a ReLU, 1 elsewhere, half that on the branches that write into a residual stream, ``QKV_GAIN``
    for the encoder's qkv), biases a small one, LayerNorm affines around 1 and 0, embeddings and the
    position encoding's Gaussian matrix unit normals (as ``nn.Embedding`` and ``torch.randn`` draw them),
    the absolute position embedding and the dense embedding 0.1.  The relative-position tables, which the
    source zero-initialises for training, are drawn at ``REL_POS_SPREAD / sqrt(head dim)``, so that they
    move the output."""
    w = _widths(config["model"])
    spec = {}

    def weight(key, shape, fan_in, gain=1.0):
        spec[f"{key}.weight"] = (tuple(shape), ("normal", 0.0, (gain / fan_in) ** 0.5))

    def bias(key, c):
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.02))

    def affine(key, c):
        spec[f"{key}.weight"] = ((c,), ("normal", 1.0, 0.1))
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.1))

    def linear(key, cin, cout, gain=1.0):
        weight(key, (cout, cin), cin, gain)
        bias(key, cout)

    def embedding(key, n, c, std=1.0):
        spec[f"{key}.weight"] = ((n, c), ("normal", 0.0, std))

    e, p, grid = w["embed_dim"], w["patch_size"], w["img_size"] // w["patch_size"]
    cin = config["model"].get("in_channels", 3)
    hd = e // w["num_heads"]
    weight("image_encoder.patch_embed.proj", (e, cin, p, p), cin * p * p)
    bias("image_encoder.patch_embed.proj", e)
    spec["image_encoder.pos_embed"] = ((1, grid, grid, e), ("normal", 0.0, 0.1))
    for i in range(w["depth"]):
        blk = f"image_encoder.blocks.{i}"
        side = grid if i in w["global_attn_indexes"] else w["window_size"]
        affine(f"{blk}.norm1", e)
        linear(f"{blk}.attn.qkv", e, 3 * e, gain=QKV_GAIN)
        linear(f"{blk}.attn.proj", e, e, gain=0.5)
        spec[f"{blk}.attn.rel_pos_h"] = ((2 * side - 1, hd), ("normal", 0.0, REL_POS_SPREAD / hd ** 0.5))
        spec[f"{blk}.attn.rel_pos_w"] = ((2 * side - 1, hd), ("normal", 0.0, REL_POS_SPREAD / hd ** 0.5))
        affine(f"{blk}.norm2", e)
        linear(f"{blk}.mlp.lin1", e, e * w["mlp_ratio"])
        linear(f"{blk}.mlp.lin2", e * w["mlp_ratio"], e, gain=0.5)
    d = w["out_chans"]
    weight("image_encoder.neck.0", (d, e, 1, 1), e)
    affine("image_encoder.neck.1", d)
    weight("image_encoder.neck.2", (d, d, 3, 3), 9 * d)
    affine("image_encoder.neck.3", d)
    spec["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = ((2, d // 2), ("normal", 0.0, 1.0))
    for i in range(4):
        embedding(f"prompt_encoder.point_embeddings.{i}", 1, d)
    embedding("prompt_encoder.not_a_point_embed", 1, d)
    m = w["mask_in_chans"]
    weight("prompt_encoder.mask_downscaling.0", (m // 4, 1, 2, 2), 4)
    bias("prompt_encoder.mask_downscaling.0", m // 4)
    affine("prompt_encoder.mask_downscaling.1", m // 4)
    weight("prompt_encoder.mask_downscaling.3", (m, m // 4, 2, 2), m)
    bias("prompt_encoder.mask_downscaling.3", m)
    affine("prompt_encoder.mask_downscaling.4", m)
    weight("prompt_encoder.mask_downscaling.6", (d, m, 1, 1), m)
    bias("prompt_encoder.mask_downscaling.6", d)
    embedding("prompt_encoder.no_mask_embed", 1, d, 0.1)

    def attention(key, down):
        internal = d // down
        for proj in ("q_proj", "k_proj", "v_proj"):
            linear(f"{key}.{proj}", d, internal)
        linear(f"{key}.out_proj", internal, d, gain=0.5)

    for i in range(w["decoder_depth"]):
        layer = f"mask_decoder.transformer.layers.{i}"
        attention(f"{layer}.self_attn", 1)
        affine(f"{layer}.norm1", d)
        attention(f"{layer}.cross_attn_token_to_image", 2)
        affine(f"{layer}.norm2", d)
        linear(f"{layer}.mlp.lin1", d, w["decoder_mlp_dim"], gain=2.0)
        linear(f"{layer}.mlp.lin2", w["decoder_mlp_dim"], d, gain=0.5)
        affine(f"{layer}.norm3", d)
        affine(f"{layer}.norm4", d)
        attention(f"{layer}.cross_attn_image_to_token", 2)
    attention("mask_decoder.transformer.final_attn_token_to_image", 2)
    affine("mask_decoder.transformer.norm_final_attn", d)
    tokens = w["num_multimask_outputs"] + 1
    embedding("mask_decoder.iou_token", 1, d)
    embedding("mask_decoder.mask_tokens", tokens, d)
    weight("mask_decoder.output_upscaling.0", (d, d // 4, 2, 2), d)
    bias("mask_decoder.output_upscaling.0", d // 4)
    affine("mask_decoder.output_upscaling.1", d // 4)
    weight("mask_decoder.output_upscaling.3", (d // 4, d // 8, 2, 2), d // 4)
    bias("mask_decoder.output_upscaling.3", d // 8)
    for t in range(tokens):
        mlp = f"mask_decoder.output_hypernetworks_mlps.{t}.layers"
        linear(f"{mlp}.0", d, d, gain=2.0)
        linear(f"{mlp}.1", d, d, gain=2.0)
        linear(f"{mlp}.2", d, d // 8)
    hidden = w["iou_head_hidden_dim"]
    dims = [d] + [hidden] * (w["iou_head_depth"] - 1) + [tokens]
    for j in range(w["iou_head_depth"]):
        linear(f"mask_decoder.iou_prediction_head.layers.{j}", dims[j], dims[j + 1],
               gain=2.0 if j < w["iou_head_depth"] - 1 else 1.0)
    return spec


def get_rel_pos(q_size, k_size, rel_pos):
    """image_encoder.py::get_rel_pos where the table has the length the sizes ask for."""
    if rel_pos.shape[0] != int(2 * max(q_size, k_size) - 1):
        raise NotImplementedError("the reference does not resize relative-position tables")
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative_coords.long()]


def window_partition(x, window_size):
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, c), (hp, wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.view(b, hp // window_size, wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


class Model:
    """The eval forward over the state dict ``sd`` (float32 tensors)."""

    def __init__(self, config, sd, train=False, precision=None, checkpoint=False):
        if train:
            raise NotImplementedError("the SAM reference serves only")
        self.sd, self.p, self.w = sd, Precision(precision), _widths(config["model"])

    def _ln(self, x, key, eps):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], eps)

    def _ln2d(self, x, key, eps=1e-6):
        """common.py's LayerNorm2d."""
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + eps)
        return self.sd[f"{key}.weight"][:, None, None] * x + self.sd[f"{key}.bias"][:, None, None]

    def _lin(self, x, key):
        return self.p.linear(x, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"])

    def _rel_pos(self, attn, q, key, q_size, k_size):
        """image_encoder.py::add_decomposed_rel_pos."""
        q_h, q_w = q_size
        k_h, k_w = k_size
        rh = get_rel_pos(q_h, k_h, self.sd[f"{key}.rel_pos_h"])
        rw = get_rel_pos(q_w, k_w, self.sd[f"{key}.rel_pos_w"])
        b, _, dim = q.shape
        r_q = self.p(q.reshape(b, q_h, q_w, dim))
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, self.p(rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, self.p(rw))
        return (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
            b, q_h * q_w, k_h * k_w)

    def _attention(self, x, key):
        """image_encoder.py's Attention with use_rel_pos, ``ATTENTION_BLOCK`` images at a time."""
        if x.shape[0] > ATTENTION_BLOCK:
            return torch.cat([self._attention(x[i:i + ATTENTION_BLOCK], key)
                              for i in range(0, x.shape[0], ATTENTION_BLOCK)])
        b, h, w, _ = x.shape
        heads = self.w["num_heads"]
        qkv = self._lin(x, f"{key}.qkv").reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
        scale = q.shape[-1] ** -0.5
        attn = self.p.matmul(q * scale, k.transpose(-2, -1))
        attn = self._rel_pos(attn, q, key, (h, w), (h, w)).softmax(dim=-1)
        y = self.p.matmul(attn, v).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self._lin(y, f"{key}.proj")

    def _block(self, x, i):
        blk = f"image_encoder.blocks.{i}"
        window = 0 if i in self.w["global_attn_indexes"] else self.w["window_size"]
        shortcut = x
        x = self._ln(x, f"{blk}.norm1", 1e-6)
        if window > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, window)
        x = self._attention(x, f"{blk}.attn")
        if window > 0:
            x = window_unpartition(x, window, pad_hw, (h, w))
        x = shortcut + x
        y = self._lin(F.gelu(self._lin(self._ln(x, f"{blk}.norm2", 1e-6), f"{blk}.mlp.lin1")), f"{blk}.mlp.lin2")
        return x + y

    def _encoder(self, x):
        wt = self.sd["image_encoder.patch_embed.proj.weight"]
        x = self.p.conv(x, wt, self.sd["image_encoder.patch_embed.proj.bias"], wt.shape[-1]).permute(0, 2, 3, 1)
        x = x + self.sd["image_encoder.pos_embed"]
        for i in range(self.w["depth"]):
            x = self._block(x, i)
        x = self.p.conv(x.permute(0, 3, 1, 2), self.sd["image_encoder.neck.0.weight"])
        x = self._ln2d(x, "image_encoder.neck.1")
        x = self.p.conv(x, self.sd["image_encoder.neck.2.weight"], None, 1, 1)
        return self._ln2d(x, "image_encoder.neck.3")

    def _pe_encoding(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def _prompt(self, boxes, size, grid):
        """PromptEncoder.forward for boxes alone: (sparse, dense, image_pe)."""
        coords = (boxes + 0.5).reshape(-1, 2, 2).clone()
        coords[:, :, 0] = coords[:, :, 0] / size
        coords[:, :, 1] = coords[:, :, 1] / size
        corners = self._pe_encoding(coords)
        corners[:, 0, :] += self.sd["prompt_encoder.point_embeddings.2.weight"]
        corners[:, 1, :] += self.sd["prompt_encoder.point_embeddings.3.weight"]
        dense = self.sd["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(
            boxes.shape[0], -1, grid, grid)
        ones = torch.ones((grid, grid), device=boxes.device)
        y_embed = (ones.cumsum(dim=0) - 0.5) / grid
        x_embed = (ones.cumsum(dim=1) - 0.5) / grid
        pe = self._pe_encoding(torch.stack([x_embed, y_embed], dim=-1)).permute(2, 0, 1).unsqueeze(0)
        return corners, dense, pe

    def _token_attention(self, key, q, k, v, heads):
        """transformer.py's Attention."""
        def separate(t):
            b, n, c = t.shape
            return t.reshape(b, n, heads, c // heads).transpose(1, 2)

        q, k, v = (separate(self._lin(t, f"{key}.{name}")) for t, name in ((q, "q_proj"), (k, "k_proj"), (v, "v_proj")))
        attn = self.p.matmul(q, k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
        out = self.p.matmul(torch.softmax(attn, dim=-1), v)
        b, nh, n, c = out.shape
        return self._lin(out.transpose(1, 2).reshape(b, n, nh * c), f"{key}.out_proj")

    def _two_way(self, image_embedding, image_pe, point_embedding):
        heads = self.w["decoder_heads"]
        keys = image_embedding.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = point_embedding
        for i in range(self.w["decoder_depth"]):
            layer = f"mask_decoder.transformer.layers.{i}"
            if i == 0:  # skip_first_layer_pe
                queries = self._token_attention(f"{layer}.self_attn", queries, queries, queries, heads)
            else:
                q = queries + point_embedding
                queries = queries + self._token_attention(f"{layer}.self_attn", q, q, queries, heads)
            queries = self._ln(queries, f"{layer}.norm1", 1e-5)
            q, k = queries + point_embedding, keys + key_pe
            queries = queries + self._token_attention(f"{layer}.cross_attn_token_to_image", q, k, keys, heads)
            queries = self._ln(queries, f"{layer}.norm2", 1e-5)
            mlp = self._lin(F.relu(self._lin(queries, f"{layer}.mlp.lin1")), f"{layer}.mlp.lin2")
            queries = self._ln(queries + mlp, f"{layer}.norm3", 1e-5)
            q, k = queries + point_embedding, keys + key_pe
            keys = keys + self._token_attention(f"{layer}.cross_attn_image_to_token", k, q, queries, heads)
            keys = self._ln(keys, f"{layer}.norm4", 1e-5)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + self._token_attention("mask_decoder.transformer.final_attn_token_to_image", q, k, keys,
                                                  heads)
        return self._ln(queries, "mask_decoder.transformer.norm_final_attn", 1e-5), keys

    def _mlp(self, x, key, layers):
        for j in range(layers):
            x = self._lin(x, f"{key}.layers.{j}")
            x = F.relu(x) if j < layers - 1 else x
        return x

    def _decoder(self, emb, pe, sparse, dense):
        """MaskDecoder.predict_masks, mask 0."""
        tokens = torch.cat([self.sd["mask_decoder.iou_token.weight"], self.sd["mask_decoder.mask_tokens.weight"]], 0)
        tokens = torch.cat([tokens.unsqueeze(0).expand(sparse.shape[0], -1, -1), sparse], dim=1)
        src = emb + dense
        b, c, h, w = src.shape
        hs, src = self._two_way(src, pe.expand(b, -1, -1, -1), tokens)
        src = src.transpose(1, 2).reshape(b, c, h, w)
        up = self.p.conv_transpose(src, self.sd["mask_decoder.output_upscaling.0.weight"],
                                   self.sd["mask_decoder.output_upscaling.0.bias"], 2)
        up = F.gelu(self._ln2d(up, "mask_decoder.output_upscaling.1"))
        up = F.gelu(self.p.conv_transpose(up, self.sd["mask_decoder.output_upscaling.3.weight"],
                                          self.sd["mask_decoder.output_upscaling.3.bias"], 2))
        hyper = torch.stack([self._mlp(hs[:, 1 + t], f"mask_decoder.output_hypernetworks_mlps.{t}", 3)
                             for t in range(self.w["num_multimask_outputs"] + 1)], dim=1)
        b, c, h, w = up.shape
        masks = self.p.matmul(hyper, up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        return masks[:, 0:1]

    def __call__(self, x):
        """Normalised float32 NCHW images [B,3,S,S] (S the encoder's size) -> logits [B, 1, S, S]."""
        size, grid = self.w["img_size"], self.w["img_size"] // self.w["patch_size"]
        emb = self._encoder(x)
        boxes = torch.tensor(self.w["box"], dtype=torch.float32, device=x.device).expand(x.shape[0], 4)
        sparse, dense, pe = self._prompt(boxes, size, grid)
        masks = self._decoder(emb, pe, sparse, dense)
        masks = F.interpolate(masks, (size, size), mode="bilinear", align_corners=False)
        masks = masks[..., :x.shape[2], :x.shape[3]]
        if masks.shape[2:] != x.shape[2:]:
            masks = F.interpolate(masks, x.shape[2:], mode="bilinear", align_corners=False)
        return masks

"""The diffusers SD-1.x, SD-2.x and SDXL state-dict geometry (keys and
shapes), enumerated (the port's copy of
``distdiff_tpu/weights/sd15_geometry.py``).

``sd15_unet_state_shapes``, ``sd15_vae_state_shapes`` and
``sd15_text_state_shapes`` give, at their defaults, the key list a
``runwayml/stable-diffusion-v1-5`` save ships (UNet 859,520,964, VAE
83,653,863 and text encoder 123,060,480 parameters); with ``ctx=1024,
linear_proj=True`` and ``d=1024, layers=23`` the list of a
``stabilityai/stable-diffusion-2-1`` save (UNet 865,910,724, text encoder
340,387,840; the VAE is SD-1.x's), and the list diffusers would write for
another such geometry (the tiny test configs). ``sdxl_unet_state_shapes``
and ``sdxl_text2_state_shapes`` give a
``stabilityai/stable-diffusion-xl-base-1.0`` save's UNet (2,567,463,684)
and ``text_encoder_2`` (694,659,840; its ``text_encoder`` and VAE have
SD-1.5's geometry). ``PARAM_TOTALS`` pins the published totals.
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]


def _resnet(prefix: str, cin: int, cout: int, temb: int | None,
            out: Dict[str, Shape]) -> None:
    out[f"{prefix}.norm1.weight"] = (cin,)
    out[f"{prefix}.norm1.bias"] = (cin,)
    out[f"{prefix}.conv1.weight"] = (cout, cin, 3, 3)
    out[f"{prefix}.conv1.bias"] = (cout,)
    if temb is not None:
        out[f"{prefix}.time_emb_proj.weight"] = (cout, temb)
        out[f"{prefix}.time_emb_proj.bias"] = (cout,)
    out[f"{prefix}.norm2.weight"] = (cout,)
    out[f"{prefix}.norm2.bias"] = (cout,)
    out[f"{prefix}.conv2.weight"] = (cout, cout, 3, 3)
    out[f"{prefix}.conv2.bias"] = (cout,)
    if cin != cout:
        out[f"{prefix}.conv_shortcut.weight"] = (cout, cin, 1, 1)
        out[f"{prefix}.conv_shortcut.bias"] = (cout,)


def _transformer2d(prefix: str, c: int, ctx: int, out: Dict[str, Shape],
                   depth: int = 1, linear_proj: bool = False) -> None:
    """Transformer2DModel. SD-1.5: depth 1, conv projections. SD-2.x: LINEAR
    proj_in/out (use_linear_projection=True)."""
    out[f"{prefix}.norm.weight"] = (c,)
    out[f"{prefix}.norm.bias"] = (c,)
    proj_shape = (c, c) if linear_proj else (c, c, 1, 1)
    out[f"{prefix}.proj_in.weight"] = proj_shape
    out[f"{prefix}.proj_in.bias"] = (c,)
    for d in range(depth):
        tb = f"{prefix}.transformer_blocks.{d}"
        for n in ("norm1", "norm2", "norm3"):
            out[f"{tb}.{n}.weight"] = (c,)
            out[f"{tb}.{n}.bias"] = (c,)
        # self-attention (no qkv biases in SD)
        out[f"{tb}.attn1.to_q.weight"] = (c, c)
        out[f"{tb}.attn1.to_k.weight"] = (c, c)
        out[f"{tb}.attn1.to_v.weight"] = (c, c)
        out[f"{tb}.attn1.to_out.0.weight"] = (c, c)
        out[f"{tb}.attn1.to_out.0.bias"] = (c,)
        # cross-attention reads the text context
        out[f"{tb}.attn2.to_q.weight"] = (c, c)
        out[f"{tb}.attn2.to_k.weight"] = (c, ctx)
        out[f"{tb}.attn2.to_v.weight"] = (c, ctx)
        out[f"{tb}.attn2.to_out.0.weight"] = (c, c)
        out[f"{tb}.attn2.to_out.0.bias"] = (c,)
        # GEGLU feed-forward
        out[f"{tb}.ff.net.0.proj.weight"] = (8 * c, c)
        out[f"{tb}.ff.net.0.proj.bias"] = (8 * c,)
        out[f"{tb}.ff.net.2.weight"] = (c, 4 * c)
        out[f"{tb}.ff.net.2.bias"] = (c,)
    out[f"{prefix}.proj_out.weight"] = proj_shape
    out[f"{prefix}.proj_out.bias"] = (c,)


def sd15_unet_state_shapes(
    chans=(320, 640, 1280, 1280),
    layers: int = 2,
    ctx: int = 768,
    cross_attention=(True, True, True, False),
    in_channels: int = 4,
    out_channels: int = 4,
    temb_mult: int = 4,
    linear_proj: bool = False,
) -> Dict[str, Shape]:
    """Defaults = SD-1.5. Other geometries (e.g. the test-tiny config, or
    SD-2.1 via ``ctx=1024, linear_proj=True`` — use_linear_projection in
    diffusers' stabilityai/stable-diffusion-2-1 unet config) produce the
    key list diffusers would emit for that architecture."""
    chans = list(chans)
    temb = chans[0] * temb_mult
    nb = len(chans)
    out: Dict[str, Shape] = {}
    out["conv_in.weight"] = (chans[0], in_channels, 3, 3)
    out["conv_in.bias"] = (chans[0],)
    out["time_embedding.linear_1.weight"] = (temb, chans[0])
    out["time_embedding.linear_1.bias"] = (temb,)
    out["time_embedding.linear_2.weight"] = (temb, temb)
    out["time_embedding.linear_2.bias"] = (temb,)

    # down: CrossAttnDownBlock2D where cross_attention[i], else DownBlock2D
    for i in range(nb):
        cin = chans[0] if i == 0 else chans[i - 1]
        cout = chans[i]
        for j in range(layers):
            _resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout,
                    cout, temb, out)
            if cross_attention[i]:
                _transformer2d(f"down_blocks.{i}.attentions.{j}", cout, ctx, out,
                               linear_proj=linear_proj)
        if i < nb - 1:
            out[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (cout, cout, 3, 3)
            out[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (cout,)

    _resnet("mid_block.resnets.0", chans[-1], chans[-1], temb, out)
    _transformer2d("mid_block.attentions.0", chans[-1], ctx, out,
                   linear_proj=linear_proj)
    _resnet("mid_block.resnets.1", chans[-1], chans[-1], temb, out)

    # up: mirror of down with layers+1 resnets, each consuming a skip
    # connection (diffusers get_up_block wiring)
    rev = list(reversed(chans))  # [1280, 1280, 640, 320] for SD-1.5
    rev_attn = list(reversed(list(cross_attention)))
    for i in range(nb):
        prev_out = rev[i - 1] if i > 0 else rev[0]
        cout = rev[i]
        skip_src = rev[min(i + 1, nb - 1)]
        for j in range(layers + 1):
            res_skip = skip_src if j == layers else cout
            res_in = prev_out if j == 0 else cout
            _resnet(f"up_blocks.{i}.resnets.{j}", res_in + res_skip, cout,
                    temb, out)
            if rev_attn[i]:
                _transformer2d(f"up_blocks.{i}.attentions.{j}", cout, ctx, out,
                               linear_proj=linear_proj)
        if i < nb - 1:
            out[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (cout, cout, 3, 3)
            out[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (cout,)

    out["conv_norm_out.weight"] = (chans[0],)
    out["conv_norm_out.bias"] = (chans[0],)
    out["conv_out.weight"] = (out_channels, chans[0], 3, 3)
    out["conv_out.bias"] = (out_channels,)
    return out


def sdxl_unet_state_shapes(
    chans=(320, 640, 1280),
    layers: int = 2,
    ctx: int = 2048,
    cross_attention=(False, True, True),
    transformer_depth=(0, 2, 10),
    addition_embed_dim: int = 2816,
    in_channels: int = 4,
    out_channels: int = 4,
    temb_mult: int = 4,
) -> Dict[str, Shape]:
    """The diffusers SDXL UNet: per-block transformer depth (the mid block
    takes the deepest level's), linear projections, and the
    ``add_embedding`` MLP beside the time embedding. Defaults = SDXL-base."""
    chans = list(chans)
    temb = chans[0] * temb_mult
    nb = len(chans)
    out: Dict[str, Shape] = {}
    out["conv_in.weight"] = (chans[0], in_channels, 3, 3)
    out["conv_in.bias"] = (chans[0],)
    for emb, d_in in (("time_embedding", chans[0]), ("add_embedding", addition_embed_dim)):
        out[f"{emb}.linear_1.weight"] = (temb, d_in)
        out[f"{emb}.linear_1.bias"] = (temb,)
        out[f"{emb}.linear_2.weight"] = (temb, temb)
        out[f"{emb}.linear_2.bias"] = (temb,)

    for i in range(nb):
        cin = chans[0] if i == 0 else chans[i - 1]
        cout = chans[i]
        for j in range(layers):
            _resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout, temb, out)
            if cross_attention[i] and transformer_depth[i] > 0:
                _transformer2d(f"down_blocks.{i}.attentions.{j}", cout, ctx, out,
                               depth=transformer_depth[i], linear_proj=True)
        if i < nb - 1:
            out[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (cout, cout, 3, 3)
            out[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (cout,)

    _resnet("mid_block.resnets.0", chans[-1], chans[-1], temb, out)
    _transformer2d("mid_block.attentions.0", chans[-1], ctx, out,
                   depth=transformer_depth[-1], linear_proj=True)
    _resnet("mid_block.resnets.1", chans[-1], chans[-1], temb, out)

    rev = list(reversed(chans))
    rev_attn = list(reversed(list(cross_attention)))
    rev_depth = list(reversed(list(transformer_depth)))
    for i in range(nb):
        prev_out = rev[i - 1] if i > 0 else rev[0]
        cout = rev[i]
        skip_src = rev[min(i + 1, nb - 1)]
        for j in range(layers + 1):
            res_skip = skip_src if j == layers else cout
            res_in = prev_out if j == 0 else cout
            _resnet(f"up_blocks.{i}.resnets.{j}", res_in + res_skip, cout, temb, out)
            if rev_attn[i] and rev_depth[i] > 0:
                _transformer2d(f"up_blocks.{i}.attentions.{j}", cout, ctx, out,
                               depth=rev_depth[i], linear_proj=True)
        if i < nb - 1:
            out[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (cout, cout, 3, 3)
            out[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (cout,)

    out["conv_norm_out.weight"] = (chans[0],)
    out["conv_norm_out.bias"] = (chans[0],)
    out["conv_out.weight"] = (out_channels, chans[0], 3, 3)
    out["conv_out.bias"] = (out_channels,)
    return out


def sdxl_text2_state_shapes(d: int = 1280, ff: int | None = None, layers: int = 32,
                            vocab: int = 49408, pos: int = 77,
                            embed: int = 1280) -> Dict[str, Shape]:
    """SDXL's ``text_encoder_2``: the OpenCLIP-bigG text tower as
    transformers' ``CLIPTextModelWithProjection`` (a bias-free
    ``text_projection`` Linear, ``[embed, d]``). Defaults = SDXL-base."""
    out = sd15_text_state_shapes(d=d, ff=ff, layers=layers, vocab=vocab, pos=pos)
    out["text_projection.weight"] = (embed, d)
    return out


def _vae_attention(prefix: str, c: int, out: Dict[str, Shape]) -> None:
    out[f"{prefix}.group_norm.weight"] = (c,)
    out[f"{prefix}.group_norm.bias"] = (c,)
    for n in ("to_q", "to_k", "to_v"):
        out[f"{prefix}.{n}.weight"] = (c, c)
        out[f"{prefix}.{n}.bias"] = (c,)
    out[f"{prefix}.to_out.0.weight"] = (c, c)
    out[f"{prefix}.to_out.0.bias"] = (c,)


def sd15_vae_state_shapes(
    chans=(128, 256, 512, 512),
    layers: int = 2,
    lat: int = 4,
) -> Dict[str, Shape]:
    chans = list(chans)
    nb = len(chans)
    out: Dict[str, Shape] = {}

    # encoder
    out["encoder.conv_in.weight"] = (chans[0], 3, 3, 3)
    out["encoder.conv_in.bias"] = (chans[0],)
    for i in range(nb):
        cin = chans[0] if i == 0 else chans[i - 1]
        cout = chans[i]
        for j in range(layers):
            _resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                    cin if j == 0 else cout, cout, None, out)
        if i < nb - 1:
            out[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"] = (
                cout, cout, 3, 3)
            out[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"] = (cout,)
    _resnet("encoder.mid_block.resnets.0", chans[-1], chans[-1], None, out)
    _vae_attention("encoder.mid_block.attentions.0", chans[-1], out)
    _resnet("encoder.mid_block.resnets.1", chans[-1], chans[-1], None, out)
    out["encoder.conv_norm_out.weight"] = (chans[-1],)
    out["encoder.conv_norm_out.bias"] = (chans[-1],)
    out["encoder.conv_out.weight"] = (2 * lat, chans[-1], 3, 3)
    out["encoder.conv_out.bias"] = (2 * lat,)

    out["quant_conv.weight"] = (2 * lat, 2 * lat, 1, 1)
    out["quant_conv.bias"] = (2 * lat,)
    out["post_quant_conv.weight"] = (lat, lat, 1, 1)
    out["post_quant_conv.bias"] = (lat,)

    # decoder
    rev = list(reversed(chans))  # [512, 512, 256, 128] for SD
    out["decoder.conv_in.weight"] = (rev[0], lat, 3, 3)
    out["decoder.conv_in.bias"] = (rev[0],)
    _resnet("decoder.mid_block.resnets.0", rev[0], rev[0], None, out)
    _vae_attention("decoder.mid_block.attentions.0", rev[0], out)
    _resnet("decoder.mid_block.resnets.1", rev[0], rev[0], None, out)
    for i in range(nb):
        cin = rev[0] if i == 0 else rev[i - 1]
        cout = rev[i]
        for j in range(layers + 1):
            _resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                    cin if j == 0 else cout, cout, None, out)
        if i < nb - 1:
            out[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"] = (
                cout, cout, 3, 3)
            out[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"] = (cout,)
    out["decoder.conv_norm_out.weight"] = (rev[-1],)
    out["decoder.conv_norm_out.bias"] = (rev[-1],)
    out["decoder.conv_out.weight"] = (3, rev[-1], 3, 3)
    out["decoder.conv_out.bias"] = (3,)
    return out


def sd15_text_state_shapes(
    d: int = 768, ff: int | None = None, layers: int = 12,
    vocab: int = 49408, pos: int = 77,
) -> Dict[str, Shape]:
    """CLIPTextModel (ViT-L/14 text tower) state dict (without the
    ``position_ids`` buffer some saves carry)."""
    ff = ff if ff is not None else 4 * d
    out: Dict[str, Shape] = {
        "text_model.embeddings.token_embedding.weight": (vocab, d),
        "text_model.embeddings.position_embedding.weight": (pos, d),
        "text_model.final_layer_norm.weight": (d,),
        "text_model.final_layer_norm.bias": (d,),
    }
    for i in range(layers):
        p = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{p}.self_attn.{n}.weight"] = (d, d)
            out[f"{p}.self_attn.{n}.bias"] = (d,)
        out[f"{p}.layer_norm1.weight"] = (d,)
        out[f"{p}.layer_norm1.bias"] = (d,)
        out[f"{p}.mlp.fc1.weight"] = (ff, d)
        out[f"{p}.mlp.fc1.bias"] = (ff,)
        out[f"{p}.mlp.fc2.weight"] = (d, ff)
        out[f"{p}.mlp.fc2.bias"] = (d,)
        out[f"{p}.layer_norm2.weight"] = (d,)
        out[f"{p}.layer_norm2.bias"] = (d,)
    return out


PARAM_TOTALS = {
    "unet": 859_520_964,
    "vae": 83_653_863,
    "text": 123_060_480,
    # SD-2.1 (diffusers' stabilityai/stable-diffusion-2-1)
    "sd21_unet": 865_910_724,
    "sd21_text": 340_387_840,
    # SDXL-base (diffusers' stabilityai/stable-diffusion-xl-base-1.0)
    "sdxl_unet": 2_567_463_684,
    "sdxl_text2": 694_659_840,
}

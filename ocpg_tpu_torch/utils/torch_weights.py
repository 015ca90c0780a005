"""Reference PyTorch checkpoints -> the JAX package's parameter tree:
counterpart of ``ocpg_tpu/utils/torch_weights.py``.

The converters produce the flax-named nested tree of numpy arrays (Dense
``kernel (in, out)``, Conv ``kernel (H, W, I, O)``, LayerNorm ``scale``,
FrozenBN stats in a separate ``frozen`` tree), key for key what the JAX
converters produce; ``utils/weights.py`` (``jax_to_state_dict``,
``load_jax_params``) then maps that tree onto the port's modules.  One key
map serves both packages.

* torchvision ResNet-50/101 -> backbone params and FrozenBN stats
  (``convert_resnet``);
* HF RoBERTa -> the text encoder (``convert_roberta``);
* Video Swin (or 2D Swin) -> the Swin backbone, with the 2D -> 3D
  relative-position-bias inflation (``convert_video_swin``,
  ``_inflate_bias_table``);
* a whole reference OCPG checkpoint (``convert_ocpg``); ``drop_class_head``
  is the finetune surgery, ``load_torch_file`` unwraps a saved file.

Pure numpy apart from deserialising the file and the bicubic resize of a
2D bias table.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _linear(sd, prefix) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _conv(sd, prefix) -> Dict[str, np.ndarray]:
    w = _t(sd[f"{prefix}.weight"])  # (O, I, H, W) -> (H, W, I, O)
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _bn_frozen(sd, prefix) -> Dict[str, np.ndarray]:
    return {name: _t(sd[f"{prefix}.{name}"])
            for name in ("weight", "bias", "running_mean", "running_var")}


def _ln(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def convert_resnet(sd: Dict, layers: Tuple[int, ...]) -> Tuple[Dict, Dict]:
    """torchvision ResNet state dict -> (params, frozen) trees."""
    params: Dict = {"conv1": _conv(sd, "conv1")}
    frozen: Dict = {"bn1": _bn_frozen(sd, "bn1")}
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            tp = f"layer{stage + 1}.{b}"
            name = f"layer{stage + 1}_{b}"
            p = {f"conv{i}": _conv(sd, f"{tp}.conv{i}") for i in (1, 2, 3)}
            f = {f"bn{i}": _bn_frozen(sd, f"{tp}.bn{i}") for i in (1, 2, 3)}
            if f"{tp}.downsample.0.weight" in sd:
                p["downsample_conv"] = _conv(sd, f"{tp}.downsample.0")
                f["downsample_bn"] = _bn_frozen(sd, f"{tp}.downsample.1")
            params[name] = p
            frozen[name] = f
    return params, frozen


def convert_roberta(sd: Dict, num_layers: int = 12) -> Dict:
    """HF RoBERTa state dict (with or without the ``roberta.`` prefix) ->
    the text encoder's tree."""
    pre = "roberta." if any(k.startswith("roberta.") for k in sd) else ""
    emb = f"{pre}embeddings"
    out: Dict = {
        "word_embeddings": {"embedding": _t(sd[f"{emb}.word_embeddings.weight"])},
        "position_embeddings": {"embedding": _t(sd[f"{emb}.position_embeddings.weight"])},
        "token_type_embeddings": {"embedding": _t(sd[f"{emb}.token_type_embeddings.weight"])},
        "embeddings_ln": _ln(sd, f"{emb}.LayerNorm"),
        "pooler": _linear(sd, f"{pre}pooler.dense"),
    }
    for i in range(num_layers):
        lp = f"{pre}encoder.layer.{i}"
        out[f"layer_{i}"] = {
            "q": _linear(sd, f"{lp}.attention.self.query"),
            "k": _linear(sd, f"{lp}.attention.self.key"),
            "v": _linear(sd, f"{lp}.attention.self.value"),
            "attn_out": _linear(sd, f"{lp}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{lp}.attention.output.LayerNorm"),
            "ffn_in": _linear(sd, f"{lp}.intermediate.dense"),
            "ffn_out": _linear(sd, f"{lp}.output.dense"),
            "ffn_ln": _ln(sd, f"{lp}.output.LayerNorm"),
        }
    return out


def _inflate_bias_table(table: np.ndarray,
                        window_size: Tuple[int, int, int]) -> np.ndarray:
    """2D -> 3D relative-position-bias inflation.

    A 2D table has ``(2*h1-1)*(2*w1-1)`` rows; the 3D module needs
    ``(2*wt-1)*(2*wh-1)*(2*ww-1)`` with the temporal offset slowest.  A grid
    of another size is bicubic-resized to ``(2*wh-1, 2*ww-1)``, then the
    table is tiled ``2*wt-1`` times.  A table already at the 3D size is
    returned as it is.
    """
    wt, wh, ww = window_size
    l3 = (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1)
    l2 = (2 * wh - 1) * (2 * ww - 1)
    l1, nh = table.shape
    if l1 == l3:
        return table
    if l1 != l2:
        import torch
        import torch.nn.functional as F

        s1 = int(round(l1 ** 0.5))
        if s1 * s1 != l1:
            raise ValueError(f"cannot infer the 2D grid of a bias table of {l1} rows")
        t = torch.from_numpy(np.ascontiguousarray(table.astype(np.float32)))
        t = t.permute(1, 0).view(1, nh, s1, s1)
        t = F.interpolate(t, size=(2 * wh - 1, 2 * ww - 1), mode="bicubic")
        table = t.view(nh, l2).permute(1, 0).numpy()
    return np.tile(table, (2 * wt - 1, 1))


def swin_convert_spec(backbone: str) -> Tuple[Tuple[int, ...], Tuple[int, int, int]]:
    """(depths, window size) of a registered Swin backbone.

    A 2D Swin is VideoSwin at window (1, 7, 7) (``models/backbone_swin2d.py``);
    with a length-1 temporal window ``_inflate_bias_table`` keeps the 2D
    tables untiled, which is what the 2D modules expect.
    """
    if backbone.startswith("video_swin"):
        from ..models.backbone_video_swin import _CONFIGS

        return tuple(_CONFIGS[backbone]["depths"]), (8, 7, 7)
    from ..models.backbone_swin2d import _CONFIGS as _CONFIGS_2D

    return tuple(_CONFIGS_2D[backbone]["depths"]), (1, 7, 7)


def convert_video_swin(sd: Dict, depths: Tuple[int, ...],
                       window_size: Tuple[int, int, int] = (8, 7, 7)) -> Dict:
    """Video Swin (or 2D Swin) state dict -> the VideoSwin tree.

    Takes a 3D checkpoint (``patch_embed.proj.weight`` of shape
    ``(C, 3, 1, 4, 4)``) or a 2D one (``(C, 3, 4, 4)``): with a (1, 4, 4)
    patch both are one 2D convolution kernel.  2D bias tables are inflated
    (``_inflate_bias_table``).
    """
    sd = {k.replace("backbone.", ""): v for k, v in sd.items()}
    pw = _t(sd["patch_embed.proj.weight"])
    if pw.ndim == 5:  # (O, I, kt, kh, kw) with kt == 1
        pw = pw[:, :, 0]
    out: Dict = {
        "patch_embed": {"kernel": pw.transpose(2, 3, 1, 0),
                        "bias": _t(sd["patch_embed.proj.bias"])},
        "patch_norm": _ln(sd, "patch_embed.norm"),
    }
    for stage, depth in enumerate(depths):
        for i in range(depth):
            lp = f"layers.{stage}.blocks.{i}"
            out[f"stage{stage}_block{i}"] = {
                "norm1": _ln(sd, f"{lp}.norm1"),
                "norm2": _ln(sd, f"{lp}.norm2"),
                "attn": {
                    "qkv": _linear(sd, f"{lp}.attn.qkv"),
                    "proj": _linear(sd, f"{lp}.attn.proj"),
                    "relative_position_bias_table": _inflate_bias_table(
                        _t(sd[f"{lp}.attn.relative_position_bias_table"]), window_size),
                },
                "mlp_fc1": _linear(sd, f"{lp}.mlp.fc1"),
                "mlp_fc2": _linear(sd, f"{lp}.mlp.fc2"),
            }
        if stage < len(depths) - 1:
            dp = f"layers.{stage}.downsample"
            out[f"downsample{stage}"] = {
                "norm": _ln(sd, f"{dp}.norm"),
                "reduction": {"kernel": _t(sd[f"{dp}.reduction.weight"]).T},
            }
    return out


def _mha(sd, prefix) -> Dict[str, Dict[str, np.ndarray]]:
    """nn.MultiheadAttention (packed in_proj) -> q/k/v/out projections."""
    w = _t(sd[f"{prefix}.in_proj_weight"])   # (3C, C)
    b = _t(sd[f"{prefix}.in_proj_bias"])     # (3C,)
    c = w.shape[1]
    return {
        "q_proj": {"kernel": w[:c].T, "bias": b[:c]},
        "k_proj": {"kernel": w[c:2 * c].T, "bias": b[c:2 * c]},
        "v_proj": {"kernel": w[2 * c:].T, "bias": b[2 * c:]},
        "out_proj": _linear(sd, f"{prefix}.out_proj"),
    }


def _mlp(sd, prefix, n_layers: int = 3) -> Dict:
    return {f"layers_{j}": _linear(sd, f"{prefix}.layers.{j}") for j in range(n_layers)}


def _feature_resizer(sd, prefix) -> Dict:
    return {"fc": _linear(sd, f"{prefix}.fc"), "layer_norm": _ln(sd, f"{prefix}.layer_norm")}


def _lfm(sd, prefix) -> Dict:
    """LFMResizeAdaptive: conv1/conv2 on the concatenated (real, imag)
    spectrum, the laplace conv, and the bias-free ``fc`` Sequential
    (0: C -> C, 2: C -> 1)."""
    return {
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
        "laplace": _conv(sd, f"{prefix}.laplace"),
        "fc1": {"kernel": _t(sd[f"{prefix}.fc.0.weight"]).T},
        "fc2": {"kernel": _t(sd[f"{prefix}.fc.2.weight"]).T},
    }


def _msda_module(sd, prefix) -> Dict:
    return {name: _linear(sd, f"{prefix}.{name}")
            for name in ("sampling_offsets", "attention_weights", "value_proj",
                         "output_proj")}


def convert_ocpg(sd: Dict, *, enc_layers: int = 4, dec_layers: int = 4,
                 num_feature_levels: int = 4, backbone: str = "resnet101",
                 text_layers: int = 12, controller_layers_total: int = 3,
                 with_box_refine: bool = True) -> Tuple[Dict, Dict]:
    """A whole reference OCPG checkpoint -> (params, frozen) trees.

    Every parameter of the reference model: the backbone (the Joiner's
    ``backbone.0.body``), the RoBERTa text encoder, the text and sentence
    FeatureResizers, the VL-fusion attention, the per-level input
    projections with their GroupNorms and LFM pairs, the deformable
    transformer (encoder and decoder layers, level embedding, reference
    points, the per-layer box heads), the class heads, the controller, the
    level-set projections and the MSO refiner.
    """
    params: Dict = {}
    frozen: Dict = {}

    bprefix = "backbone.0.body."
    bb_sd = {k[len(bprefix):]: v for k, v in sd.items() if k.startswith(bprefix)}
    if backbone.startswith("video_swin") or backbone.startswith("swin"):
        # the reference Swin backbone keeps each stage's downsample apart
        # (``downsamples.{s}.*``); move them back to the Kinetics layout
        # ``layers.{s}.downsample.*`` that convert_video_swin reads
        remapped = {}
        for k, v in bb_sd.items():
            if k.startswith("downsamples."):
                parts = k.split(".")
                remapped[f"layers.{parts[1]}.downsample." + ".".join(parts[2:])] = v
            else:
                remapped[k] = v
        depths, window = swin_convert_spec(backbone)
        params["backbone"] = convert_video_swin(remapped, depths, window)
        # a transformer backbone has no BN statistics: no frozen entry
    else:
        layers = (3, 4, 23, 3) if backbone == "resnet101" else (3, 4, 6, 3)
        params["backbone"], frozen["backbone"] = convert_resnet(bb_sd, layers)

    tprefix = "text_encoder.text_backbone."
    tx_sd = {k[len(tprefix):]: v for k, v in sd.items() if k.startswith(tprefix)}
    params["text_encoder"] = convert_roberta(tx_sd, text_layers)

    params["text_proj"] = _feature_resizer(sd, "text_proj")
    params["sentence_proj"] = _feature_resizer(sd, "sentence_proj")
    params["fusion_module"] = {"multihead_attn": _mha(sd, "fusion_module.multihead_attn")}
    params["query_embed"] = _t(sd["query_embed.weight"])
    params["controller"] = _mlp(sd, "controller", controller_layers_total)
    params["ls_feat_viz"] = _conv(sd, "ls_feat_viz")
    params["ls_text_proj"] = _linear(sd, "ls_text_proj")

    for l in range(num_feature_levels):
        params[f"input_proj_{l}"] = _conv(sd, f"input_proj.{l}.0")
        params[f"input_proj_gn_{l}"] = _ln(sd, f"input_proj.{l}.1")
        params[f"input_fft_{l}"] = _lfm(sd, f"input_fft.{l}")
        params[f"input_fft_post_{l}"] = _lfm(sd, f"input_fft_post.{l}")

    params["mask_refine"] = {
        name: _conv(sd, f"mask_refine.{name}")
        for name in ("conv1_1div8", "conv2_1div8", "conv1_1div4", "conv2_1div4", "out_conv")
    }

    tr: Dict = {
        "level_embed": _t(sd["transformer.level_embed"]),
        "reference_points": _linear(sd, "transformer.reference_points"),
    }
    for i in range(enc_layers):
        lp = f"transformer.encoder.layers.{i}"
        tr[f"encoder_layer_{i}"] = {
            "self_attn": _msda_module(sd, f"{lp}.self_attn"),
            "norm1": _ln(sd, f"{lp}.norm1"),
            "norm2": _ln(sd, f"{lp}.norm2"),
            "linear1": _linear(sd, f"{lp}.linear1"),
            "linear2": _linear(sd, f"{lp}.linear2"),
        }
    for i in range(dec_layers):
        lp = f"transformer.decoder.layers.{i}"
        tr[f"decoder_layer_{i}"] = {
            "cross_attn": _msda_module(sd, f"{lp}.cross_attn"),
            "self_attn": _mha(sd, f"{lp}.self_attn"),
            "norm1": _ln(sd, f"{lp}.norm1"),
            "norm2": _ln(sd, f"{lp}.norm2"),
            "norm3": _ln(sd, f"{lp}.norm3"),
            "linear1": _linear(sd, f"{lp}.linear1"),
            "linear2": _linear(sd, f"{lp}.linear2"),
        }
        if with_box_refine:
            tr[f"bbox_embed_{i}"] = _mlp(sd, f"bbox_embed.{i}", 3)
    params["transformer"] = tr

    for i in range(dec_layers):
        params[f"class_embed_{i}"] = _linear(sd, f"class_embed.{i}")

    return params, frozen


def drop_class_head(params: Dict) -> Dict:
    """Finetune surgery: the tree without its ``class_embed*`` heads."""
    return {k: v for k, v in params.items() if not k.startswith("class_embed")}


def load_torch_file(path: str) -> Dict:
    """A saved checkpoint's state dict: the object itself, or its
    ``"model"`` or ``"state_dict"`` entry."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj

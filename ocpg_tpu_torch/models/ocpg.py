"""OCPG top-level model: counterpart of ``ocpg_tpu/models/ocpg.py``.

backbone (ResNet-50/101, Video Swin or 2D Swin) -> text encoder -> per
level {input_proj -> GroupNorm -> LFM -> VL fusion -> LFM} -> deformable
transformer -> class / box heads -> dynamic-conv mask head -> MSO ->
nearest x4 upsample, then one of three branches:

* train (``train=True``, with ``targets``): the mask head for every
  decoder layer, the matcher per layer (no gradient), the level-set
  features, and the matched query of each layer refined; it returns the
  dict ``models/criterion.py::compute_criterion`` reads;
* DAVIS / YTVOS eval: the best query by its valid-frame mean score (or the
  one ``query_override`` forces), refined alone;
* A2D / JHMDB / RefCOCO eval: every query refined.

With ``valid_indices`` (A2D / JHMDB) only the one annotated frame per clip
goes on after the backbone.  The eval branches run under ``no_grad``.
Dropout is active in training mode (``model.train()``); ``model.eval()``
with ``train=True`` is the JAX model's ``deterministic=True``.

Inputs keep the JAX layouts: ``samples (B, T, H, W, 3)`` normalised frames
and ``samples_mask (B, T, H, W)`` (True = padding).  Inside, feature maps
are NCHW.  With ``compute_dtype="bfloat16"`` the forward runs under
``torch.autocast``; the heads, the sampling math, LFM and the level-set
features stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import OCPGConfig
from ..ops.image import bicubic_resize, bilinear_resize, nearest_resize, pixel_shuffle
from .backbone_resnet import build_resnet
from .backbone_swin2d import build_swin_2d
from .backbone_video_swin import build_video_swin
from .cross_modal import LFM, VisionLanguageFusion
from .deformable_transformer import DeformableTransformer
from .layers import MLP, FeatureResizer, float32_island, inverse_sigmoid
from .mask_head import (MSO, apply_dynamic_conv_shared, compute_locations,
                        dynamic_params_layout)
from .matcher import match, matcher_config
from .position_encoding import position_embedding_sine_1d, position_embedding_sine_2d
from .text_encoder import RobertaConfig, RobertaEncoder

NUM_BACKBONE_LEVELS = 3


def _gather_query(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x (B, T, Q, ...) at query q (B,) -> (B, T, 1, ...)."""
    idx = q.reshape(-1, *([1] * (x.dim() - 1))).expand(x.shape[0], x.shape[1], 1,
                                                       *x.shape[3:])
    return torch.gather(x, 2, idx)


def build_backbone(cfg: OCPGConfig) -> nn.Module:
    if cfg.backbone in ("resnet50", "resnet101"):
        return build_resnet(cfg.backbone, cfg.dilation)
    if cfg.backbone.startswith("video_swin"):
        return build_video_swin(cfg.backbone)
    if cfg.backbone.startswith("swin"):
        return build_swin_2d(cfg.backbone)
    raise NotImplementedError(cfg.backbone)


class OCPG(nn.Module):
    def __init__(self, cfg: OCPGConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_dim
        self.backbone = build_backbone(cfg)
        bb_ch = self.backbone.num_channels
        self.text_encoder = RobertaEncoder(RobertaConfig(
            vocab_size=cfg.text_vocab, hidden_size=cfg.text_hidden,
            num_layers=cfg.text_layers, num_heads=cfg.text_heads,
            intermediate_size=cfg.text_ffn, max_position_embeddings=cfg.text_max_pos))
        self.text_proj = FeatureResizer(cfg.text_hidden, hidden)
        self.sentence_proj = FeatureResizer(cfg.text_hidden, hidden)
        self.fusion_module = VisionLanguageFusion(hidden, cfg.nheads)
        for l in range(cfg.num_feature_levels):
            if l < NUM_BACKBONE_LEVELS:
                conv = nn.Conv2d(bb_ch[-NUM_BACKBONE_LEVELS + l], hidden, 1)
            else:
                cin = bb_ch[-1] if l == NUM_BACKBONE_LEVELS else hidden
                conv = nn.Conv2d(cin, hidden, 3, stride=2, padding=1)
            setattr(self, f"input_proj_{l}", conv)
            setattr(self, f"input_proj_gn_{l}", nn.GroupNorm(32, hidden, eps=1e-5))
            setattr(self, f"input_fft_{l}", LFM(hidden, sigma=7.0))
            setattr(self, f"input_fft_post_{l}", LFM(hidden, sigma=7.0))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, hidden))
        self.transformer = DeformableTransformer(
            d_model=hidden, nhead=cfg.nheads, num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward,
            dropout=cfg.dropout, num_feature_levels=cfg.num_feature_levels, dec_n_points=cfg.dec_n_points,
            enc_n_points=cfg.enc_n_points, with_box_refine=cfg.with_box_refine)
        for lvl in range(cfg.dec_layers):
            setattr(self, f"class_embed_{lvl}", nn.Linear(hidden, cfg.num_classes))
            if not cfg.with_box_refine:
                setattr(self, f"bbox_embed_{lvl}", MLP(hidden, hidden, 4, 3))
        self.weight_nums, self.bias_nums = dynamic_params_layout(
            cfg.mask_dim, cfg.dynamic_mask_channels, cfg.controller_layers, cfg.rel_coord)
        num_params = sum(self.weight_nums) + sum(self.bias_nums)
        self.controller = MLP(hidden, hidden, num_params, 3)
        self.mask_refine = MSO(cfg.dynamic_mask_channels, (bb_ch[0], bb_ch[1]))
        # train-only: the level-set features (a JAX tree from an eval init lacks them)
        self.ls_feat_viz = nn.Conv2d(hidden, 8, 3, padding=1)
        self.ls_text_proj = nn.Linear(hidden, 8)
        self.matcher_cfg = matcher_config(cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.cfg.compute_dtype]

    def forward(self, samples: torch.Tensor, samples_mask: torch.Tensor,
                text_ids: torch.Tensor, text_attn_mask: torch.Tensor,
                sizes: torch.Tensor, valid_indices: Optional[torch.Tensor] = None,
                *, targets: Optional[Dict[str, torch.Tensor]] = None,
                query_override: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        if train and targets is None:
            raise ValueError("the train forward needs targets")
        with torch.autocast(device_type=samples.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16), \
                torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return self._forward(samples, samples_mask, text_ids, text_attn_mask,
                                 sizes, valid_indices, query_override,
                                 targets if train else None)

    def _forward(self, samples, samples_mask, text_ids, text_attn_mask, sizes,
                 valid_indices, query_override, targets):
        cfg = self.cfg
        b, t_in, H, W, _ = samples.shape
        hidden = cfg.hidden_dim
        nq = cfg.num_queries
        dev = samples.device

        # ---------------- visual backbone (frames in the batch dim) ----------
        frames = samples.reshape(b * t_in, H, W, 3).permute(0, 3, 1, 2)
        frames_mask = samples_mask.reshape(b * t_in, H, W)
        if self.cfg.backbone.startswith("resnet"):
            feats = list(self.backbone(frames))
        else:   # Swin: the video variant attends across the clip's t_in frames
            feats = list(self.backbone(frames, num_frames=t_in))
        if valid_indices is not None:        # A2D / JHMDB: one annotated frame
            sel = torch.arange(b, device=dev) * t_in + valid_indices.long()
            feats = [f[sel] for f in feats]
            frames = frames[sel]
            frames_mask = frames_mask[sel]
            t = 1
        else:
            t = t_in
        bt = b * t

        def mask_at(size):
            return nearest_resize(frames_mask[:, None].float(), size)[:, 0] > 0.5

        feat_masks = [mask_at(tuple(f.shape[-2:])) for f in feats]
        visual_pos = [position_embedding_sine_2d(m, num_pos_feats=hidden // 2)
                      for m in feat_masks]

        # ---------------- text encoder (no gradient when frozen) ------------
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not cfg.freeze_text_encoder):
            text_feat, text_pooled = self.text_encoder(text_ids, text_attn_mask)
        text_word = self.text_proj(text_feat)                     # (B, Lt, C)
        text_sentence = self.sentence_proj(text_pooled)           # (B, C)
        text_pad_mask = text_attn_mask == 0
        text_pos = position_embedding_sine_1d(text_pad_mask, num_pos_feats=hidden)

        # ---------------- spectrum-guided cross-modal fusion ----------------
        srcs, masks_l, poses = [], [], []
        high_filter = None
        for l in range(cfg.num_feature_levels):
            if l < NUM_BACKBONE_LEVELS:
                src = getattr(self, f"input_proj_{l}")(feats[-NUM_BACKBONE_LEVELS + l])
                lvl_mask = feat_masks[-NUM_BACKBONE_LEVELS + l]
                pos_l = visual_pos[-NUM_BACKBONE_LEVELS + l]
            else:
                base = feats[-1] if l == NUM_BACKBONE_LEVELS else srcs[-1]
                src = getattr(self, f"input_proj_{l}")(base)
                lvl_mask = mask_at(tuple(src.shape[-2:]))
                pos_l = position_embedding_sine_2d(lvl_mask, num_pos_feats=hidden // 2)
            src = getattr(self, f"input_proj_gn_{l}")(src)
            n_, c_, h_, w_ = src.shape
            src, high_filter = getattr(self, f"input_fft_{l}")(src, high_filter)
            # (b t) c h w -> b (t h w) c: a video's frame tokens fuse with its text
            vis = src.flatten(2).transpose(1, 2).reshape(b, t * h_ * w_, c_)
            vis = self.fusion_module(vis, text_word, text_pad_mask, text_pos)
            src = vis.reshape(n_, h_ * w_, c_).transpose(1, 2).reshape(n_, c_, h_, w_)
            src, high_filter = getattr(self, f"input_fft_post_{l}")(src, high_filter)
            srcs.append(src)
            masks_l.append(lvl_mask)
            poses.append(pos_l)

        # ---------------- deformable transformer ----------------
        tgt = text_sentence[:, None, :].repeat(1, t, 1).reshape(bt, 1, hidden)
        tgt = tgt.expand(bt, nq, hidden)
        tr = self.transformer(srcs, tgt, masks_l, poses, self.query_embed)
        hs = tr["hs"]                                   # (L, BT, Q, C)
        ldec = hs.shape[0]
        inter_references = tr["inter_references"]       # (L, BT, Q, 4)
        memory = tr["memory_features"]                  # [8x, 16x, 32x] NCHW

        # ---------------- class / box heads ----------------
        with float32_island(hs):
            outputs_class = torch.stack([
                getattr(self, f"class_embed_{lvl}")(hs[lvl].float()) for lvl in range(ldec)])
            if cfg.with_box_refine:
                outputs_coord = tr["inter_coords"]
            else:
                coords = []
                for lvl in range(ldec):
                    reference = tr["init_reference"] if lvl == 0 else inter_references[lvl - 1]
                    tmp = getattr(self, f"bbox_embed_{lvl}")(hs[lvl].float())
                    tmp = torch.cat([tmp[..., :2] + inverse_sigmoid(reference),
                                     tmp[..., 2:]], -1)
                    coords.append(torch.sigmoid(tmp))
                outputs_coord = torch.stack(coords)
        outputs_class = outputs_class.reshape(ldec, b, t, nq, cfg.num_classes)
        outputs_coord = outputs_coord.reshape(ldec, b, t, nq, 4)
        out: Dict[str, torch.Tensor] = {
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
        }

        # ---------------- segmentation ----------------
        h8, w8 = memory[0].shape[-2:]
        # bicubic in the compute dtype, float32 from the sum onward
        dtype = self.compute_dtype
        memory_fusion = sum(bicubic_resize(x.to(dtype), (h8, w8)).float() for x in memory)
        mask_ch = cfg.dynamic_mask_channels
        # eval reads the last layer's patches only; train every layer's
        head_lvls = range(ldec) if targets is not None else [ldec - 1]
        patches = []                                           # (B, T, Q, h8, w8, 16)
        with float32_island(hs):
            scale_wh = torch.stack([sizes[:, 1], sizes[:, 0]], -1).float()    # (B, 2) xy
            locations = compute_locations(h8, w8, stride=8, device=dev)
            for lvl in head_lvls:
                params = self.controller(hs[lvl].float()).reshape(bt, nq, -1)
                refs = inter_references[lvl][..., :2].reshape(b, t, nq, 2)
                refs = refs * scale_wh[:, None, None, :]
                if cfg.rel_coord:
                    rel = refs[:, :, :, None, None, :] - locations[None, None, None]
                    rel_g = rel.reshape(bt, nq, h8, w8, 2)
                else:
                    rel_g = torch.zeros((bt, nq, h8, w8, 2), device=dev)
                patch = apply_dynamic_conv_shared(
                    memory_fusion.permute(0, 2, 3, 1), rel_g, params, mask_ch,
                    self.weight_nums, self.bias_nums)         # (BT, Q, h8, w8, 16)
                patches.append(patch.reshape(b, t, nq, h8, w8, mask_ch))
        patch = patches[-1]
        feat_4x, feat_8x = feats[0], feats[1]

        if targets is not None:
            return self._train_outputs(out, targets, outputs_class, outputs_coord, patches,
                                       memory_fusion, text_sentence, frames, feat_4x,
                                       feat_8x, (b, t, H, W))

        if cfg.dataset_file not in ("a2d", "jhmdb") and "refcoco" not in cfg.dataset_file:
            # DAVIS / YTVOS: the best query by its mean score over the valid
            # (not wholly padded) frames
            scores = torch.sigmoid(out["pred_logits"].float())               # (B,T,Q,K)
            frame_ok = 1.0 - samples_mask.reshape(b, t, -1).all(-1).float()
            fv = frame_ok[:, :, None, None]
            mean_scores = (scores * fv).sum(1) / fv.sum(1).clamp(min=1.0)
            out["query_scores"] = mean_scores                                # (B,Q,K)
            out["query_frames"] = fv.sum(1)[:, 0, 0]                         # (B,)
            best_q = mean_scores.max(-1).values.argmax(-1)                   # (B,)
            if query_override is not None:
                qov = query_override.to(device=dev, dtype=best_q.dtype)
                best_q = torch.where(qov >= 0, qov, best_q)
            out["pred_logits"] = _gather_query(out["pred_logits"], best_q)
            out["pred_boxes"] = _gather_query(out["pred_boxes"], best_q)
            refs_pen = inter_references[-2][..., :2].reshape(b, t, nq, 2)
            out["reference_points"] = _gather_query(refs_pen, best_q)
            psel = _gather_query(patch, best_q)[:, :, 0]                     # (B,T,h8,w8,16)
            psel = psel.reshape(bt, h8, w8, mask_ch).permute(0, 3, 1, 2)
            refined = self.mask_refine(psel.to(dtype), feat_4x, feat_8x)     # (BT,1,h4,w4)
            full = nearest_resize(refined.float(), (H, W))[:, 0]
            out["pred_masks"] = full.reshape(b, t, 1, H, W)
            return out

        # A2D / JHMDB / RefCOCO: refine every query; the backbone features
        # are shared by the Q queries of each (b, t) group
        patch_q = patch.reshape(bt * nq, h8, w8, mask_ch).permute(0, 3, 1, 2)
        refined = self.mask_refine(patch_q.to(dtype), feat_4x, feat_8x, queries=nq)
        full = nearest_resize(refined.float(), (H, W))[:, 0]
        out["pred_masks"] = full.reshape(b, t, nq, H, W)
        return out

    def _train_outputs(self, out, targets, outputs_class, outputs_coord, patches,
                       memory_fusion, text_sentence, frames, feat_4x, feat_8x, dims):
        """The train branch: matcher per layer, level-set features, the
        matched query of every layer refined."""
        cfg = self.cfg
        b, t, H, W = dims
        bt = b * t
        nq, mask_ch = cfg.num_queries, cfg.dynamic_mask_channels
        _, _, _, h8, w8, _ = patches[0].shape
        h2, w2 = h8 * 4, w8 * 4
        ldec = len(patches)
        # pixel-shuffled patch logits at 1/2 resolution: the matcher's input
        formatcher = [pixel_shuffle(p.reshape(bt * nq, h8, w8, mask_ch).permute(0, 3, 1, 2),
                                    4)[:, 0].reshape(b, t, nq, h2, w2) for p in patches]
        matched = torch.stack([
            match(self.matcher_cfg, outputs_class[lvl], outputs_coord[lvl], formatcher[lvl],
                  targets["labels"], targets["boxes"], targets["masks"], targets["valid"])
            for lvl in range(ldec)])                                       # (L, B)

        # level-set targets: [frame, 8 learned channels, text similarity]
        with float32_island(memory_fusion):
            ls_viz = bilinear_resize(self.ls_feat_viz(memory_fusion), (h2, w2),
                                     align_corners=True)                  # (BT, 8, h2, w2)
            txt8 = self.ls_text_proj(text_sentence.float())               # (B, 8)
            txt8 = txt8.repeat_interleave(t, 0)[:, :, None, None]         # (BT, 8, 1, 1)
            dot = (ls_viz * txt8).sum(1)
            cos = (ls_viz / torch.linalg.vector_norm(ls_viz, dim=1, keepdim=True).clamp(min=1e-12)
                   * (txt8 / torch.linalg.vector_norm(txt8, dim=1, keepdim=True).clamp(min=1e-12))
                   ).sum(1)
            sim_cross = dot / (cos + 1e-5)                                 # (BT, h2, w2)
            # the frames as the backbone saw them (rounded to the compute dtype)
            img_ori = bilinear_resize(frames.to(self.compute_dtype).float(), (h2, w2),
                                      align_corners=True)                 # (BT, 3, h2, w2)
            ls_features = torch.cat([img_ori, ls_viz, sim_cross[:, None]], 1)
        out["ls_features"] = ls_features.permute(0, 2, 3, 1).reshape(b, t, h2, w2, 12)
        out["frames"] = img_ori.permute(0, 2, 3, 1).reshape(b, t, h2, w2, 3)

        masks, lows = [], []
        for lvl in range(ldec):
            sel = matched[lvl]
            psel = _gather_query(patches[lvl], sel)[:, :, 0]              # (B, T, h8, w8, 16)
            psel = psel.reshape(bt, h8, w8, mask_ch).permute(0, 3, 1, 2)
            refined = self.mask_refine(psel.to(self.compute_dtype), feat_4x, feat_8x)
            masks.append(nearest_resize(refined.float(), (H, W))[:, 0].reshape(b, t, H, W))
            lows.append(_gather_query(formatcher[lvl], sel)[:, :, 0])      # (B, T, h2, w2)
        out["pred_masks"] = masks[-1]
        out["pred_masks_low"] = lows[-1]
        out["matched"] = matched
        out["outputs_class"] = outputs_class                               # (L, B, T, Q, K)
        out["outputs_coord"] = outputs_coord
        out["pred_masks_layers"] = torch.stack(masks)                      # (L, B, T, H, W)
        out["pred_masks_low_layers"] = torch.stack(lows)
        return out

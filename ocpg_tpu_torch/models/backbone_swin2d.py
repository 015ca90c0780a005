"""2D Swin backbone (Swin-T/S/B/L, window 7): counterpart of
``ocpg_tpu/models/backbone_swin2d.py``.

A 2D Swin block is a Video-Swin block with a length-1 temporal window, so
this is ``VideoSwin`` with window (1, 7, 7) and one frame per clip: one
implementation, two backbones.  All four stages are returned, as for the
video variant; the model takes the last three.
"""

from __future__ import annotations

from .backbone_video_swin import VideoSwin

_CONFIGS = {
    "swin_t_p4w7": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s_p4w7": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_b_p4w7": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_l_p4w7": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


def build_swin_2d(arch: str, use_checkpoint: bool = False) -> VideoSwin:
    return VideoSwin(window_size=(1, 7, 7), num_frames=1, use_checkpoint=use_checkpoint,
                     **_CONFIGS[arch])

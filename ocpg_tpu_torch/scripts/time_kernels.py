"""Device times of the port's MSDA and window-attention kernels at the calls
their paths make, printed as one JSON line, for comparing two trees of the
port on one card in one call (parent, change, change, parent).

    python3 ocpg_tpu_torch/scripts/time_kernels.py

times the ``ocpg_tpu_torch`` that Python imports first: this tree's, or
another tree's put first on PYTHONPATH (for example a ``git archive`` of an
earlier commit unpacked under a directory that ``.gitignore`` lists).  Each
tree builds its kernels into its own ``ocpg_tpu_torch/_build/``.  All times
are bf16 device times from ``chip_smoke.cuda_ms`` (CUDA events around
launches queued behind a sleep kernel), on the seeded inputs of
``bench_msda_bwd.msda_inputs`` (seed 7):

* K1, the MSDA forward, at the serving and train encoder calls;
* K2, its backward, at the train encoder call;
* K5 (dense rows) and K6 (fused K) at the serving and train encoder calls,
  on uniform and on clustered samples;
* K7, the window attention, at the Video Swin-B stage-0 shifted block
  (bw = 322, 4 heads, n = 245, dh = 32, with the SW-MSA mask).

It takes no arguments and needs a GPU (exit 2 without one).
"""

from __future__ import annotations

import json
import os
import sys

import torch

# chip_smoke.py (the timing helpers and the serving calls) sits at the root
# of a tree; appended, so a tree put first on PYTHONPATH provides the port
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
import ocpg_tpu_torch  # noqa: E402
from ocpg_tpu_torch.ops import _build  # noqa: E402
from ocpg_tpu_torch.ops import ms_deform_attn as msda  # noqa: E402
from ocpg_tpu_torch.ops import ms_deform_attn_variants as msda_var  # noqa: E402
from ocpg_tpu_torch.ops import window_attention as wattn  # noqa: E402
from ocpg_tpu_torch.scripts.bench_msda_bwd import (HEAD_DIM, HEADS, TRAIN_N,  # noqa: E402
                                                   TRAIN_SHAPES, msda_inputs)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    _build.build_all()
    bf16 = torch.bfloat16
    ms = {}
    for name, shapes, n in (("serve encoder", cs.SERVE_SHAPES, cs.SERVE_N),
                            ("train encoder", TRAIN_SHAPES, TRAIN_N)):
        lq = sum(h * w for h, w in shapes)
        for clustered in (False, True):
            value, x, y, aw = msda_inputs(shapes, n, lq, bf16, seed=7, clustered=clustered)
            call = f"{name} clustered" if clustered else name
            if not clustered:
                ms[f"K1 {call}"] = cs.cuda_ms(
                    lambda: msda.ms_deform_attn_cm(value, shapes, x, y, aw), 50)
            if name == "train encoder" and not clustered:
                g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                    device="cuda").manual_seed(9), device="cuda").to(bf16)
                ms[f"K2 {call}"] = cs.cuda_ms(
                    lambda: msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g), 20)
            ms[f"K5 {call}"] = cs.cuda_ms(
                lambda: msda_var.ms_deform_attn_cm_r4(value, shapes, x, y, aw), 20)
            ms[f"K6 {call}"] = cs.cuda_ms(
                lambda: msda_var.ms_deform_attn_cm_fk(value, shapes, x, y, aw), 20)
    bw, heads, n, mask_np = cs.swin_call(cs.SWIN_GRIDS[0], cs.SWIN_HEADS[0])
    mask = torch.from_numpy(mask_np).cuda().to(bf16)
    q, k, v, bias = cs.wattn_inputs(bw, heads, n, bf16, seed=11)
    ms["K7 swin-B stage 0 masked"] = cs.cuda_ms(
        lambda: wattn.window_attention(q, k, v, bias, mask), 20)
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(ocpg_tpu_torch.__file__)),
                      "nvidia_smi": cs.nvidia_smi_line(), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Reader arithmetic that metrics of several kinds of cell share: each
``metrics/<name>.<kind>.py`` calls one of these with its kind, so that the
train and the serving split of a quantity read it alike."""

from __future__ import annotations

from typing import Mapping, Optional

from benchmark import counts


def idle_share(ctx: Mapping, kind: str) -> Optional[float]:
    """1 less the union of the device's kernel, copy and set intervals over
    the traced span's wall time, in percent."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or tr.wall_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.wall_us)


def msda_roofline(ctx: Mapping, kind: str) -> Optional[float]:
    """The MSDA calls' least time (forward, and backward where the call took a
    gradient) over the device time of the MSDA kernels, in percent."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or not ctx.get("msda_calls"):
        return None
    bound = 0.0
    for shapes, n, m, d, p, lq, es, grad in ctx["msda_calls"]:
        bound += counts.bound_s(*counts.msda_fwd(shapes, n, m, d, p, lq, es))
        if grad:
            bound += counts.bound_s(*counts.msda_bwd(shapes, n, m, d, p, lq, es))
    device_s = (tr.kernel_us("msda_fwd_kernel") + tr.kernel_us("msda_bwd_kernel")) / 1e6
    return 100.0 * bound / device_s if device_s > 0 else None


def wattn_roofline(ctx: Mapping, kind: str) -> Optional[float]:
    """The window-attention calls' least time (forward, and backward where the
    call took a gradient) over the device time of K7 and of the kernels under
    its autograd backward, in percent; nothing to read without a Swin."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or not ctx.get("wattn_calls"):
        return None
    bound = 0.0
    for (bw, n, h, dh), es, mask_windows, grad in ctx["wattn_calls"]:
        bound += counts.bound_s(*counts.wattn_fwd(bw, n, h, dh, es, mask_windows))
        if grad:
            bound += counts.bound_s(*counts.wattn_bwd(bw, n, h, dh, es, mask_windows))
    device_s = (tr.kernel_us("wattn_fwd")
                + tr.device_us_under("WindowAttentionFunctionBackward")) / 1e6
    return 100.0 * bound / device_s if device_s > 0 else None

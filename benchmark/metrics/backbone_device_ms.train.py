"""Device ms per train step of the visual backbone, forward and backward:
what the program launches inside its ``ocpg.backbone`` span (the forward,
on the step's thread) and inside its ``ocpg.grad.backbone`` span (the
backbone's backward, on the thread that runs autograd's backward), each
matched by correlation id on its span's own thread, over the ``ocpg.step``
spans.  None where either span is absent (a program without them, a
serving cell)."""

from benchmark.metrics import program_spans

SPANS = ("ocpg.backbone", "ocpg.grad.backbone")


def read(ctx):
    tr = program_spans.traced(ctx, "train")
    if tr is None or not tr.device:
        return None
    steps = program_spans.named(tr, "ocpg.step")
    if not steps or not all(program_spans.named(tr, s) for s in SPANS):
        return None
    return sum(tr.device_us_under(s) for s in SPANS) / len(steps) / 1e3

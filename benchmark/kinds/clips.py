"""Runs a ``"work": "clips"`` mix: the program's train step in a closed
loop, steps back to back as a training job runs them.

Set-up builds the model (``models/build.py``), loads the run's weights
(``weights.py``), builds ``engine/optim.py``'s optimizer and
``engine/train.py::TrainStep``, makes the pool of compact batches
(``generate.make_clips``) and runs the first three steps through that same
step object on three different batches; their losses, the first step's
gradient (from AdamW's first moment) and the change of the parameters over
the three are kept for the check.  The window then runs steps on the next
batches of the pool until ``--seconds`` have passed, each ending in the
step's own host sync.  With ``--trace 1`` three more steps run under the
profiler.  Then the program is freed and the reference
(``reference/step.py``) runs the same three steps from the same weights on
the same batches, with the same dropout draws, in float32 with TF32 off.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional

import torch

from benchmark import check, counts, device as dev, generate, trace, weights
from benchmark.reference import lowp, plain_ops
from benchmark.reference.step import ReferenceTrainStep

FIRST_STEPS = 3
TRACED_STEPS = 3


def model_fields(cell, seed: int) -> Dict:
    fields = dict(cell.config["model"])
    fields["seed"] = int(seed) + 1        # the dropout generator's seed
    return fields


def build_program(fields: Mapping, seed: int, device):
    """The program's model with the run's weights, its optimizer and TrainStep."""
    from ocpg_tpu_torch.config import OCPGConfig
    from ocpg_tpu_torch.engine.optim import build_optimizer
    from ocpg_tpu_torch.engine.train import TrainStep
    from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config

    cfg = OCPGConfig(**fields)
    model = build_model(cfg, device)
    weights.load_weights(model, weights.draw_for(fields, seed, device))
    opt = build_optimizer(model, cfg)
    return TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), opt)


def stepped(model: torch.nn.Module, adamw: torch.optim.Optimizer) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p in adamw.state}


def first_readings(call, model, adamw, pool: List, fields, seed: int, device,
                   keep: Optional[Dict] = None) -> Dict:
    """Losses of the first three steps through ``call`` (which returns the
    total and the loss terms), the first step's terms, its gradient norms
    (AdamW's first moment / (1 - beta1)) and the change norms after the
    third, per leaf.  ``keep`` (a look's) also gets those gradients and
    changes whole, on the host."""
    losses, grads, terms, matched = [], {}, {}, None
    for i in range(FIRST_STEPS):
        loss, step_terms, step_matched = call(pool[i])
        losses.append(float(loss))
        if i == 0:
            terms, matched = dict(step_terms), step_matched
            first = {n: adamw.state[p]["exp_avg"] / 0.1 for n, p in stepped(model, adamw).items()}
            grads = check.leaf_norms(first)
            if keep is not None:
                keep["grads"] = {n: g.float().cpu() for n, g in first.items()}
            del first
    initial = weights.draw_for(fields, seed, device)
    changes = check.change_norms(stepped(model, adamw), initial)
    if keep is not None:
        keep["changes"] = {n: (p.detach() - initial[n]).float().cpu()
                           for n, p in stepped(model, adamw).items()}
    del initial
    return {"losses": losses, "terms": terms, "matched": matched, "grads": grads,
            "changes": changes}


def program_readings(step, pool, fields, seed, device, keep: Optional[Dict] = None) -> Dict:
    """The program's first readings; the queries its in-forward matcher
    picked are read from the forward's output by a hook."""
    seen: List[torch.Tensor] = []
    hook = step.model.register_forward_hook(
        lambda mod, args, out: seen.append(out["matched"].detach().cpu()))

    def call(batch):
        m = step(batch)
        return (m["loss"], {k: v for k, v in m.items() if k.startswith("loss_")},
                seen[-1])

    try:
        return first_readings(call, step.model, step.optimizer.adamw, pool, fields,
                              seed, device, keep)
    finally:
        hook.remove()


def reference_readings(fields, seed: int, pool, device, control: bool = False,
                       half_batch: bool = False, look: Dict = None,
                       compute_dtype: str = "float32", keep: Optional[Dict] = None) -> Dict:
    """The reference's first three steps, in ``compute_dtype`` (float32 for
    the check); ``control`` computes them one precision down
    (``reference/lowp.py``: the configuration's bfloat16 with float8
    operands), ``half_batch`` drops the second half of every batch (a fault
    the check has to catch)."""
    dev.float32_proper(device)
    ref = weights.reference_model(fields, seed, device,
                                  fields["compute_dtype"] if control else compute_dtype)
    rstep = ReferenceTrainStep(ref)

    def call(batch):
        if half_batch:
            batch = halve(batch)
        if control:
            with lowp.Float8Operands():
                loss = rstep(batch)
        else:
            loss = rstep(batch)
        matched = torch.cat(rstep.matched, 1).cpu()
        if look is not None and not look:
            look.update(terms=rstep.terms, matched=matched.tolist())
        return loss, rstep.terms, matched

    out = first_readings(call, ref, rstep.adamw, pool, fields, seed, device, keep)
    del rstep, ref
    dev.free(device)
    return out


def halve(batch: Mapping) -> Dict:
    def cut(x):
        if isinstance(x, Mapping):
            return {k: cut(v) for k, v in x.items()}
        return x[: x.shape[0] // 2]
    return cut(batch)


def compare(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The numbers compared (``check.py``)."""
    moved = check.moved_leaves(ref["grads"])
    agree = check.agreeing_layers(prog["matched"], ref["matched"])
    return {"loss_gap": check.worst_layer_gap(prog["terms"], ref["terms"], agree,
                                              ref["matched"].shape[0]),
            "matcher_flips": check.disagreeing_slots(prog["matched"], ref["matched"]),
            "change_gap": check.median_leaf_gap(prog["changes"], ref["changes"], moved)}


def count_step_flops(fields, seed: int, batch, device) -> float:
    """FLOPs of one reference train step (forward, losses, backward) at the
    batch's shapes: ``FlopCounterMode``'s products plus the frozen MSDA counts."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = weights.reference_model(fields, seed, device)
    rstep = ReferenceTrainStep(ref)
    plain_ops.MSDA_CALLS = []
    try:
        with FlopCounterMode(display=False) as fc:
            rstep(batch)
        calls = plain_ops.MSDA_CALLS
    finally:
        plain_ops.MSDA_CALLS = None
    total = float(fc.get_total_flops())
    for shapes, n, m, d, p, lq, grad in calls:
        total += counts.msda_fwd(shapes, n, m, d, p, lq, 4)[0]
        if grad:
            total += counts.msda_bwd(shapes, n, m, d, p, lq, 4)[0]
    del rstep, ref
    dev.free(device)
    return total


def run(cell, args, device: str = "cuda", t0: float = 0.0) -> Dict:
    mix, seed = cell.traffic, args.seed
    fields = model_fields(cell, seed)
    step = build_program(fields, seed, device)
    pool = generate.make_clips(mix, seed, device)
    prog = program_readings(step, pool, fields, seed, device)
    dev.synchronize(device)
    setup_s = time.perf_counter() - t0
    peak = dev.peak_bytes(device)
    dev.reset_peak(device)

    # the measured window: steps back to back on the pool's next batches
    i, steps, failed = FIRST_STEPS, 0, 0
    start = time.perf_counter()
    while True:
        metrics = step(pool[i % len(pool)])
        i += 1
        steps += 1
        failed += metrics["finite"] != 1.0
        now = time.perf_counter()
        if now - start >= args.seconds:
            break
    window_s = now - start
    window_peak = dev.peak_bytes(device)

    ctx = {"kind": "train", "setup_s": setup_s, "window_s": window_s, "steps": steps,
           "clips": steps * mix["batch"], "window_peak_bytes": window_peak}
    out = {"attempted": steps, "failed": failed,
           "memory_peak_bytes": max(peak, window_peak)}
    if args.trace:
        tracer = trace.Tracer()
        tracer.hook_module(step.model, "bench.forward")

        def tail():
            nonlocal i
            with tracer.record_calls():
                for _ in range(TRACED_STEPS):
                    with torch.profiler.record_function("bench.step"):
                        step(pool[i % len(pool)])
                    i += 1

        tr = trace.profile(tail, device)
        ctx.update(trace=tr, traced_steps=TRACED_STEPS, msda_calls=tracer.msda_calls,
                   wattn_calls=tracer.wattn_calls)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}

    del step, metrics
    dev.free(device)
    ref = reference_readings(fields, seed, pool, device)
    values = compare(prog, ref)
    out["correct"], out["checks"] = check.verdict(values, cell.limits)
    if args.trace:
        ctx["flops_per_step"] = count_step_flops(fields, seed, pool[0], device)
    out["ctx"] = ctx
    return out

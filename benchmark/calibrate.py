"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, on the card at the cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> ... [--control K] [--witness K]

For each seed the program's numbers against the reference (the lower
readings), and for the first ``K`` seeds the control's (the reference one
precision down in the program's place, ``reference/lowp.py``) and each
fault's that the cell can have: in a train cell half of every batch left
out (the reference on the first half, its mean over those rows) and a
step that returns its state unchanged (the program's readings with no leaf
moved); in a serving cell an answer altered where it is produced (each
request's masks handed back as the next request's of its video, and a
single request's with its first frame negated) and the wrong query chosen
(the reference's worst-scored query's masks in the program's place).

A train cell's seeds also give the look behind the numbers that are not
compared (``check.py``): the first step's worst loss terms, the matched
queries, the worst leaves of the first gradient and of the change, each
with its reference gradient beside AdamW's eps and the cosine between the
two sides' tensors.  For the first ``--witness`` seeds two witnesses with
the configuration's round-off taken out or put in elsewhere follow: the
program run in float32 (TF32 off), and the reference run in the
configuration's bfloat16, each against the float32 reference.

One JSON line per reading.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from benchmark import check
from benchmark import device as dev
from benchmark import generate
from benchmark.manifest import find_cell, work_module, load_manifest

ADAMW_EPS = 1e-8        # engine/optim.py's
LOOK_LEAVES = 6


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def worst_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   keep: Optional[List[str]] = None) -> Tuple[float, str]:
    """The worst leaf's | |x| - |x_ref| | / max(|x_ref|, median |x_ref|), and its name;
    a leaf on one side only reads 1."""
    names = keep if keep is not None else sorted(set(prog) | set(ref))
    gaps = check.leaf_gaps(prog, ref, names)
    if not gaps:
        return 0.0, ""
    i = max(range(len(gaps)), key=lambda k: gaps[k] if math.isfinite(gaps[k]) else math.inf)
    return (gaps[i] if math.isfinite(gaps[i]) else math.inf), names[i]


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The worst relative gap of the step losses."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    if len(prog) != len(ref) or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def shares(norms: Mapping[str, float]) -> Dict[str, float]:
    """Each leaf's norm over the norm of all leaves together."""
    total = math.sqrt(sum(v * v for v in norms.values())) or 1.0
    return {k: v / total for k, v in norms.items()}


def all_terms_gap(prog: Mapping, ref: Mapping) -> float:
    """The median over the agreeing layers' terms taken together."""
    agree = check.agreeing_layers(prog["matched"], ref["matched"])
    return check.median_term_gap(prog["terms"], ref["terms"], agree, ref["matched"].shape[0])


def look_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """Numbers that are not compared (``check.py`` says why), for the record."""
    moved = check.moved_leaves(ref["grads"])
    return {"total_loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "total_loss_gap_3steps": loss_gap(prog["losses"], ref["losses"]),
            "loss_gap_all_terms": all_terms_gap(prog, ref),
            "grad_gap_worst": worst_leaf_gap(prog["grads"], ref["grads"])[0],
            "grad_gap_median": check.median_leaf_gap(prog["grads"], ref["grads"]),
            "grad_share_gap_median": check.median_leaf_gap(shares(prog["grads"]),
                                                           shares(ref["grads"])),
            "change_gap_worst": worst_leaf_gap(prog["changes"], ref["changes"], moved)[0]}


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else float("nan")


def leaf_look(prog: Mapping, ref: Mapping, pk: Mapping, rk: Mapping,
              names: Optional[List[str]] = None) -> List[Dict]:
    """The change's worst moved leaves (or ``names``): each leaf's change gap,
    both change norms, the reference's first gradient (its norm, its RMS
    over AdamW's eps, the share of its elements under eps, where AdamW's
    first update is no longer sign-sized but scales with the gradient), the
    gradient's gap and the cosines of the two sides' gradients and changes."""
    moved = check.moved_leaves(ref["grads"])
    med = check.median([ref["changes"][n] for n in moved])
    if names is None:
        gaps = dict(zip(moved, check.leaf_gaps(prog["changes"], ref["changes"], moved)))
        names = sorted(gaps, key=lambda n: -gaps[n])[:LOOK_LEAVES]
    gmed = check.median(list(ref["grads"].values()))
    out = []
    for n in names:
        g_ref = rk["grads"][n]
        dp, dr = prog["changes"][n], ref["changes"][n]
        out.append({
            "leaf": n, "numel": g_ref.numel(),
            "change_gap": abs(dp - dr) / max(dr, med, 1e-30),
            "change": dp, "change_ref": dr,
            "grad_ref": ref["grads"][n], "grad_ref_over_median": ref["grads"][n] / gmed,
            "grad_ref_rms_over_eps": float(g_ref.norm()) / math.sqrt(g_ref.numel()) / ADAMW_EPS,
            "grad_ref_share_under_eps": float((g_ref.abs() < ADAMW_EPS).float().mean()),
            "grad_gap": abs(prog["grads"][n] - ref["grads"][n]) / max(ref["grads"][n], 1e-30),
            "grad_cos": _cos(pk["grads"][n], g_ref),
            "change_cos": _cos(pk["changes"][n], rk["changes"][n])})
    return out


def look_terms(prog: Mapping, ref_step: Mapping) -> Dict:
    """The first step's worst loss terms and both sides' matched queries."""
    terms = {k: (v, ref_step["terms"].get(k)) for k, v in prog["terms"].items()
             if k in ref_step["terms"]}
    gaps = {k: abs(p - r) / max(abs(r), 1e-12) for k, (p, r) in terms.items()}
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:LOOK_LEAVES]
    return {"terms": [(k, g, *terms[k]) for k, g in worst],
            "matched_prog": prog["matched"].tolist(), "matched_ref": ref_step["matched"]}


def train_readings(cell, runner, seed: int, extra: bool, witness: bool, device) -> None:
    fields = runner.model_fields(cell, seed)
    step = runner.build_program(fields, seed, device)
    pool = generate.make_clips(cell.traffic, seed, device)
    pk: Dict = {}
    prog = runner.program_readings(step, pool, fields, seed, device, keep=pk)
    del step
    dev.free(device)
    ref_step: Dict = {}
    rk: Dict = {}
    ref = runner.reference_readings(fields, seed, pool, device, look=ref_step, keep=rk)
    emit(seed=seed, reading="program", **runner.compare(prog, ref), **look_numbers(prog, ref))
    emit(seed=seed, look="train", **look_terms(prog, ref_step))
    worst = leaf_look(prog, ref, pk, rk)
    emit(seed=seed, look="change", reading="program", leaves=worst)
    names = [w["leaf"] for w in worst]
    if witness:
        # the configuration's round-off taken out of the program ...
        f32 = dict(fields, compute_dtype="float32")
        dev.float32_proper(device)
        wk: Dict = {}
        try:
            step = runner.build_program(f32, seed, device)
            w = runner.program_readings(step, pool, f32, seed, device, keep=wk)
        except torch.cuda.OutOfMemoryError:
            emit(seed=seed, reading="program_float32", error="out of memory")
        else:
            emit(seed=seed, reading="program_float32", **runner.compare(w, ref),
                 **look_numbers(w, ref))
            emit(seed=seed, look="change", reading="program_float32",
                 leaves=leaf_look(w, ref, wk, rk, names))
        step = None
        dev.free(device)
        # ... and put into the reference
        bk: Dict = {}
        bf = runner.reference_readings(fields, seed, pool, device,
                                       compute_dtype=fields["compute_dtype"], keep=bk)
        emit(seed=seed, reading="reference_" + fields["compute_dtype"], **runner.compare(bf, ref),
             **look_numbers(bf, ref))
        emit(seed=seed, look="change", reading="reference_" + fields["compute_dtype"],
             leaves=leaf_look(bf, ref, bk, rk, names),
             own_worst=leaf_look(bf, ref, bk, rk)[:3])
        del bk, wk
    del pk
    if not extra:
        return
    ctl = runner.reference_readings(fields, seed, pool, device, control=True)
    emit(seed=seed, reading="control", **runner.compare(ctl, ref), **look_numbers(ctl, ref))
    half = runner.reference_readings(fields, seed, pool, device, half_batch=True)
    emit(seed=seed, reading="half_batch", **runner.compare(half, ref), **look_numbers(half, ref))
    # a step that returns its state unchanged: no leaf moves
    still = dict(prog, changes={n: 0.0 for n in prog["changes"]})
    emit(seed=seed, reading="state_unchanged", **runner.compare(still, ref))


def infer_readings(cell, runner, seed: int, extra: bool, witness: bool, device) -> None:
    mix = cell.traffic
    fields = runner.model_fields(cell)
    engine = runner.build_engine(fields, mix, seed, device)
    pool = generate.make_videos(mix, seed, device)
    served = {vi: engine.run(runner.requests_of(pool[vi]))
              for vi in runner.serving_order(pool, seed)[:mix["sample"]]}
    del engine
    dev.free(device)
    emit(seed=seed, reading="program",
         **runner.reference_gaps(fields, seed, pool, served, mix, device))
    if not extra:
        return
    emit(seed=seed, reading="control",
         **runner.reference_gaps(fields, seed, pool, served, mix, device, put="control"))
    emit(seed=seed, reading="wrong_query",
         **runner.reference_gaps(fields, seed, pool, served, mix, device, put="wrong_query"))
    altered = {}
    for vi, masks in served.items():
        if len(masks) > 1:
            altered[vi] = masks[1:] + masks[:1]
        else:
            m = masks[0].copy()
            m[0] = -m[0]
            altered[vi] = [m]
    emit(seed=seed, reading="answer_altered",
         **runner.reference_gaps(fields, seed, pool, altered, mix, device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="seeds (the first ones) that also read the control and the faults")
    p.add_argument("--witness", type=int, default=0,
                   help="seeds (the first ones) that also read a train cell's two witnesses")
    args = p.parse_args(argv)
    cell = find_cell(load_manifest(), args.workload)
    runner = work_module(cell.traffic["work"])
    readings = train_readings if cell.traffic["work"] == "clips" else infer_readings
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        readings(cell, runner, seed, i < args.control, i < args.witness, "cuda")
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

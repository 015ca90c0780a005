"""The comparisons that decide ``correct``, and the numbers they give.

Train cells (the program's first three steps against the reference's, on
the same weights, batches and dropout draws):

* ``loss_gap``: the worst over the decoder layers whose in-forward matcher
  picked the same query as the reference's for every clip of the median
  over that layer's first-step loss terms (every kind of loss) of
  |term - ref| / |ref|; no such layer reads infinite;
* ``matcher_flips``: the (decoder layer, clip) slots whose in-forward
  matcher picked another query than the reference's; their layers' terms
  are the ones ``loss_gap`` leaves out, so this bounds how many it may;
* ``change_gap``: the parameters' change over the three steps, by the
  median leaf: each leaf reads | |d| - |d_ref| | over the larger of
  |d_ref| and the median leaf's |d_ref|, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they move
  under AdamW by round-off alone).  A leaf that one side moves and the
  other does not reads 1, so a step that leaves the state unchanged reads 1.

Not compared, and why (the readings and the look behind them are in
PERF.md; ``benchmark/calibrate.py`` records them): the total loss, whose
step-1 gap jumps wherever the in-forward matcher picks another query on a
near-tie (a discrete choice that moves that layer's terms, left out
above); the worst leaf's change, which the configuration's bfloat16
round-off alone swings: the worst leaves are small frequency-domain leaves
(``input_fft*``) whose gradient lies under AdamW's eps, where the update
scales with a gradient that bfloat16 computes 20-150% off (the program in
float32 reads them small, the reference in bfloat16 as high); and the
first gradient's norms, by the worst or the median leaf, which the control
does not part from the program: the clip's one global scale moves every
leaf alike.

Serving cells (a sample of the window's requests, the reference run on each):

* ``mask_gap``: the worst over the sample of |masks - ref_q| / |ref_q| (L2
  over the request's frames and pixels), ``ref_q`` being the reference's
  mask of the query closest to the served one;
* ``score_gap``: the worst over the sample of how far that query's mean
  score lies below the reference's best query's: a served query that is
  neither the reference's best nor a near-tie of it fails here.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def change_norms(params: Mapping[str, torch.Tensor],
                 initial: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return leaf_norms({n: params[n].detach() - initial[n] for n in params})


def median(values: List[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keep: Optional[List[str]] = None) -> List[float]:
    """Every leaf's | |x| - |x_ref| | / max(|x_ref|, median |x_ref|); a leaf
    on one side only reads 1."""
    names = keep if keep is not None else sorted(set(prog) | set(ref))
    med = median([ref[n] for n in names if n in ref])
    return [1.0 if n not in prog or n not in ref
            else abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def median_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                    keep: Optional[List[str]] = None) -> float:
    gaps = leaf_gaps(prog, ref, keep)
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return median(gaps)


def agreeing_layers(prog: torch.Tensor, ref: torch.Tensor) -> List[int]:
    """The decoder layers whose matched query (``(layers, clips)``) is the
    same on both sides for every clip both hold."""
    n = min(prog.shape[1], ref.shape[1])
    return [i for i in range(min(prog.shape[0], ref.shape[0]))
            if torch.equal(prog[i, :n], ref[i, :n])]


def disagreeing_slots(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """The (layer, clip) slots, of those both sides hold, whose matched query differs."""
    n, layers = min(prog.shape[1], ref.shape[1]), min(prog.shape[0], ref.shape[0])
    return int((prog[:layers, :n] != ref[:layers, :n]).sum())


def _layer(term: str, layers: int) -> int:
    """The decoder layer of a loss term: ``loss_x_<i>`` or, unsuffixed, the last."""
    head, _, tail = term.rpartition("_")
    return int(tail) if tail.isdigit() and head.startswith("loss") else layers - 1


def median_term_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                    layers: Optional[List[int]] = None, n_layers: int = 1) -> float:
    """The median over the loss terms of |term - ref| / |ref|, over the terms
    of ``layers`` (all when None) of ``n_layers`` decoder layers; terms on
    one side only, no term left, or a gap not finite read infinite."""
    if set(prog) != set(ref) or not prog:
        return math.inf
    keys = [k for k in ref if layers is None or _layer(k, n_layers) in layers]
    gaps = [abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys]
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return median(gaps)


def worst_layer_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                    layers: List[int], n_layers: int) -> float:
    """The worst over ``layers`` of that layer's ``median_term_gap``; no layer
    reads infinite."""
    gaps = [median_term_gap(prog, ref, [i], n_layers) for i in layers]
    return max(gaps) if gaps else math.inf


def moved_leaves(ref_grads: Mapping[str, float], floor: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is at least ``floor`` times the median leaf's."""
    med = median(list(ref_grads.values()))
    return sorted(n for n, g in ref_grads.items() if g >= floor * med)


def request_gaps(served: torch.Tensor, ref_masks: torch.Tensor,
                 ref_scores: torch.Tensor) -> Tuple[float, float, int]:
    """(mask gap, score gap, query) of one served request: ``served`` (t, h, w)
    against the reference's masks (Q, t, h, w) and mean scores (Q,)."""
    s = served.to(ref_masks.device, torch.float32)
    if s.shape != ref_masks.shape[1:] or not bool(torch.isfinite(s).all()):
        return math.inf, math.inf, -1
    diff = torch.linalg.vector_norm((ref_masks - s[None]).flatten(1), dim=1)
    rel = diff / torch.linalg.vector_norm(ref_masks.flatten(1), dim=1).clamp(min=1e-30)
    q = int(rel.argmin())
    return float(rel[q]), float(ref_scores.max() - ref_scores[q]), q


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """(correct, checks): every number at or under its limit; the checks map
    each number to its value and limit, in the limits' order."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        v = float(v) if math.isfinite(v) else float("inf")
        checks[name] = {"value": v if math.isfinite(v) else "inf", "limit": float(limit)}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks

"""The numbers that decide `correct`, each a gap between what the program
served and what the reference computes from the same weights and frames.

Stream cells, taken frame by frame over the frames checked, the largest
frame's value kept:
  occ_rms   the coarse logits' difference, its 2-norm over the reference's;
  occ_max   its largest element over the reference's largest magnitude;
  occ_med   its median element's magnitude over the reference's rms;
  occ_flip  the share of coarse cells whose top class differs;
  fine_miss the fine cells that one side chose and the other did not,
            over the reference's count (the cascade picks cells by the
            coarse argmax, which rounding moves at its margins);
  fine_sel  the fine cells that the program chose and the reference's
            selection (nn/occ_head.py: select_occupied) does not pick from
            the program's own coarse argmax, or the other way round, over
            the latter's count: the cascade's choice, exact;
  fine_rms  the fine logits' difference on the cells both chose, 2-norm
            over the reference's;
  fine_med  its median element's magnitude over the reference's rms.
A frame whose outputs hold a value that is not finite reads inf, and so
does a frame on which the reference refined no cell: the cascade is
judged on every frame checked (reference/occupancy.py sets its load)."""
from __future__ import annotations

from typing import Dict, List

import torch

from .occref.nn.occ_head import fine_coordinates, select_occupied


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).norm()
    return float(d / b.double().norm().clamp(min=1e-30))


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t.float()).all())


def frame_numbers(port: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    occ_p, occ_r = port["occ"].float(), ref["occ"].float()
    out = {}
    if occ_p.shape != occ_r.shape or not _finite(occ_p):
        for k in ("occ_rms", "occ_max", "occ_med", "occ_flip"):
            out[k] = float("inf")
    else:
        d = (occ_p - occ_r).abs()
        rms_r = occ_r.double().pow(2).mean().sqrt().clamp(min=1e-30)
        out["occ_rms"] = _rel_rms(occ_p, occ_r)
        out["occ_max"] = float(d.max() / occ_r.abs().max().clamp(min=1e-30))
        out["occ_med"] = float(d.double().median() / rms_r)
        out["occ_flip"] = float((occ_p.argmax(-1) != occ_r.argmax(-1))
                                .double().mean())
    if "fine_logits" in ref:
        out.update(fine_numbers(port, ref))
    return out


def _cells(o: Dict[str, torch.Tensor]):
    """(linear ids of the valid fine cells, their logits [n, C])."""
    c = o["fine_coords"][0].long()
    v = o["fine_valid"][0].bool()
    lin = (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]
    return lin[v], o["fine_logits"][0][v].float()


def fine_numbers(port, ref) -> Dict[str, float]:
    if "fine_logits" not in port or not _finite(port["fine_logits"]):
        return dict.fromkeys(("fine_miss", "fine_rms", "fine_med"),
                             float("inf"))
    lp, fp = _cells(port)
    lr, fr = _cells(ref)
    if lr.numel() == 0:
        return dict.fromkeys(("fine_miss", "fine_rms", "fine_med"),
                             float("inf"))
    sp, ip = lp.sort()
    pos = torch.searchsorted(sp, lr).clamp(max=max(sp.numel() - 1, 0))
    hit = (sp[pos] == lr) if sp.numel() else torch.zeros_like(lr, dtype=bool)
    n_hit = int(hit.sum())
    miss = (lr.numel() + lp.numel() - 2 * n_hit) / lr.numel()
    if not bool(hit.any()):
        return {"fine_miss": miss, "fine_rms": float("inf"),
                "fine_med": float("inf")}
    a, b = fp[ip[pos[hit]]], fr[hit]
    med = (a - b).abs().double().median() / \
        b.double().pow(2).mean().sqrt().clamp(min=1e-30)
    return {"fine_miss": miss, "fine_rms": _rel_rms(a, b),
            "fine_med": float(med)}


def selection_number(port: Dict[str, torch.Tensor], capacity: int,
                     ratio: int, empty_idx: int = 0) -> float:
    """fine_sel of one frame (see above)."""
    if "fine_valid" not in port:
        return float("inf")
    mask = port["occ"][0].float().argmax(-1) != empty_idx
    coords, valid = select_occupied(mask, capacity)
    fine = fine_coordinates(coords, ratio)[valid.repeat_interleave(
        ratio ** 3)].long()
    want = (fine[:, 0] * 4096 + fine[:, 1]) * 4096 + fine[:, 2]
    got, _ = _cells(port)
    n = int(torch.isin(got, want).sum())
    return (got.numel() + want.numel() - 2 * n) / max(want.numel(), 1)


def stream_numbers(port: List[Dict[str, torch.Tensor]],
                   ref: List[Dict[str, torch.Tensor]],
                   cascade=None) -> Dict[str, float]:
    """The largest value of each number over the frames; `cascade`
    (capacity, ratio, empty class) adds fine_sel."""
    out: Dict[str, float] = {}
    for p, r in zip(port, ref):
        nums = frame_numbers(p, r)
        if cascade is not None and "fine_logits" in r:
            nums["fine_sel"] = selection_number(p, *cascade)
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}): every number the cell
    limits at or under its limit (a number the run could not give reads
    inf). The numbers without a limit are not judged."""
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
              for k, lim in sorted(limits.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def _leaf_gaps(port: Dict[str, float], ref: Dict[str, float], keep,
               med=None):
    """Each kept leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    kept leaf (`med`, where given), whichever is larger (a leaf the
    program lacks reads inf)."""
    if med is None:
        vals = sorted(ref[n] for n in keep)
        med = vals[len(vals) // 2] if vals else 0.0
    out = []
    for n in keep:
        d = abs(port.get(n, float("inf")) - ref[n]) / max(ref[n], med, 1e-30)
        out.append(d if d == d else float("inf"))
    return sorted(out) or [float("inf")]


def worst_leaves(port: Dict[str, float], ref: Dict[str, float], k: int = 5):
    """The k leaves with the widest gaps, as (name, program, reference,
    gap)."""
    vals = sorted(ref.values())
    med = vals[len(vals) // 2] if vals else 0.0
    gap = {n: abs(port.get(n, float("inf")) - r) / max(r, med, 1e-30)
           for n, r in ref.items()}
    top = sorted(gap, key=gap.get, reverse=True)[:k]
    return [(n, port.get(n), ref[n], gap[n]) for n in top]


def train_numbers(losses, first, change, r_losses, r_first, r_change,
                  matrices=()) -> Dict[str, float]:
    """Train cells, over the first steps:
      loss_gap   the worst step's loss_total gap over the reference's;
      loss0_gap  the first step's;
      grad_gap   the worst leaf's gap of the first gradient's norm (as
                 AdamW holds it after one step);
      grad_w     the same over the leaves named in `matrices` (the conv
                 and linear weights, of two axes or more);
      change_gap the worst leaf's gap of the norm of its change over the
                 steps;
      grad_med, change_med  the median leaf's gaps of the same.
    Leaves whose first gradient in the reference is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    leaf numbers."""
    gaps = []
    for p, r in zip(losses, r_losses):
        lp, lr = p.get("loss_total", float("inf")), r["loss_total"]
        d = abs(lp - lr) / max(abs(lr), 1e-30)
        gaps.append(d if d == d else float("inf"))
    loss = max(gaps, default=float("inf"))
    if len(losses) < len(r_losses):
        loss = float("inf")
    vals = sorted(r_first.values())
    med = vals[len(vals) // 2] if vals else 0.0
    keep = [n for n, v in r_first.items() if v >= 1e-3 * med]
    g = _leaf_gaps(first or {}, r_first, keep)
    c = _leaf_gaps(change, r_change, keep)
    w = _leaf_gaps(first or {}, r_first, [n for n in keep if n in matrices],
                   med)
    return {"loss_gap": loss, "loss0_gap": gaps[0] if gaps else loss,
            "grad_gap": g[-1], "grad_w": w[-1], "change_gap": c[-1],
            "grad_med": g[len(g) // 2], "change_med": c[len(c) // 2]}

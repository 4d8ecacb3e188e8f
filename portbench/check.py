"""The comparison that decides ``correct`` for a training cell.

The program's first steps (the window's own call, on the loader's
batches) are held to the reference's steps from the same weights over
the same batches and step seeds. Each number below is held to the limit
the cell's ``limits/<cell>.json`` gives:

* ``loss_gap``: the largest |program - reference| / |reference| of the
  steps' losses;
* ``grad_gap.<group>``: over the group's trained leaves, the largest gap
  between the norms of the first step's gradient as the optimizer got
  it, before its clip (the program's worked out from its optimizer state
  after that step and the norm the step reported), over the reference's
  norm of the leaf or of the group's median leaf, whichever is larger;
* ``change_gap.<group>``: the same of the norm of each leaf's change over
  the steps, over the leaves whose reference gradient is at least a
  thousandth of the group's median leaf's (a key's bias under softmax has
  a gradient of rounding alone, and Adam moves it by the learning rate
  whatever its size).

The groups: ``backbone``, the ResNet's trained stages and the conv5 RoI
head, whose leaves read the bfloat16 step's widest gaps (a random
ResNet-101's activations grow through its residual blocks, and its
weight gradients cancel to a small part of their terms); and ``vl``,
everything else (the box projection, VL-BERT, the heads). A fault that
moves the encoder's gradients by a few percent would hide under the
backbone's rounding in one worst leaf; it does not under the vl group's.
"""

from __future__ import annotations

import statistics

GROUPS = {"backbone": ("image_feature_extractor.backbone.",
                       "image_feature_extractor.roi_head_feature_extractor."),
          "vl": ()}
# leaves whose reference gradient norm is under this share of the median
# leaf's move by round-off alone; their change is not compared
ROUNDING_LEAF = 1e-3


def group_of(name):
    return "backbone" if name.startswith(GROUPS["backbone"]) else "vl"


def _worst(prog, ref, names):
    scale = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], scale, 1e-30)
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def compare(prog, ref):
    """({number: value}, the worst leaves), from the program's and the
    reference's {"loss", "grad", "change"}; a group without leaves has no
    numbers."""
    names = sorted(ref["grad"])
    missing = sorted(set(names) - set(prog["grad"]))
    if missing or len(prog["loss"]) != len(ref["loss"]):
        raise ValueError(f"the program's steps do not hold the reference's "
                         f"leaves or steps: missing {missing[:5]}")
    numbers = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                               zip(prog["loss"], ref["loss"]))}
    worst = {"leaves": len(names), "rounding_leaves": 0}
    for group in GROUPS:
        leaves = [n for n in names if group_of(n) == group]
        if not leaves:
            continue
        numbers[f"grad_gap.{group}"], worst[f"grad.{group}"] = _worst(
            prog["grad"], ref["grad"], leaves)
        median = statistics.median(ref["grad"][n] for n in leaves)
        moved = [n for n in leaves
                 if ref["grad"][n] >= ROUNDING_LEAF * median]
        numbers[f"change_gap.{group}"], worst[f"change.{group}"] = _worst(
            prog["change"], ref["change"], moved)
        worst["rounding_leaves"] += len(leaves) - len(moved)
    return numbers, worst


def verdict(numbers, limits):
    """(correct, {number: {"value", "limit"}}); every number needs its
    limit."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table

"""Gaps between the program's training state and the reference's, leaf by leaf.

A leaf's gap is the gap between the two norms, not the norm of the difference, measured against
the reference's norm of that leaf or of the median leaf, whichever is larger (some gradients are
all but zero); a comparison reads its worst leaf.
"""

import math

import torch


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.detach().double()))


def median(values) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2]) if v else 0.0


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """{key: gap} over ``keys``; a leaf missing from ``got`` counts as zero, a non-finite one as
    an infinite gap."""
    ref = {k: _norm(want[k]) for k in keys}
    floor = median(ref.values())
    gaps = {}
    for k in keys:
        denom = max(ref[k], floor)
        gap = abs(_norm(got.get(k)) - ref[k]) / denom if denom > 0 else 0.0
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst_leaf(gaps: dict) -> tuple:
    """(the largest gap, its key)."""
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moving_leaves(grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: a norm of at least ``share``
    of the median leaf's (a key's bias under softmax, for one, has none, and moves by round-off and
    weight decay alone)."""
    norms = {k: _norm(g) for k, g in grads.items()}
    floor = share * median(norms.values())
    return [k for k, n in norms.items() if n >= floor]

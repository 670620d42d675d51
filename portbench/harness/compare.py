"""The comparison that decides ``correct``: the program's answers against the
plain reference's on a sample of the window's problems.

Per problem the gap is the largest absolute difference of the six pose
components (radians and metres), NaN counting as infinite.  The numbers a
cell compares, each against the limit its workload file gives:

* ``twist_gap_p50`` / ``twist_gap_p90``: the median / 90th percentile of
  the gaps over the sample (``torch.quantile``, linear);
* ``twist_gap_max``: the widest gap;
* ``flag_mismatch_share``: the share of problems whose converged or
  success flag differs from the reference's.
"""

from __future__ import annotations

import torch


def gaps(x, x_ref):
    """Per-problem largest |difference| of [n, 6] poses, NaN as +inf."""
    d = torch.abs(x.double() - x_ref.double()).amax(-1)
    return torch.where(torch.isnan(d), torch.inf, d)


def numbers(out: dict, ref: dict) -> dict:
    """Every candidate number of the program's answers ``out`` against the
    reference's ``ref`` (dicts of [n, ...] tensors with "x" and flags)."""
    g = gaps(out["x"], ref["x"])
    q = torch.quantile(torch.where(torch.isinf(g), 1e30, g), torch.tensor(
        [0.5, 0.9], dtype=g.dtype, device=g.device))
    flags = [k for k in ("converged", "success") if k in out and k in ref]
    mismatch = torch.zeros_like(g, dtype=torch.bool)
    for k in flags:
        mismatch |= out[k] != ref[k]
    return {"twist_gap_p50": float(q[0]), "twist_gap_p90": float(q[1]),
            "twist_gap_max": float(g.max()),
            "flag_mismatch_share": float(mismatch.double().mean())}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}) for the numbers
    a cell compares; a number that is not finite fails."""
    checks = {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks

"""The online-RL goodput ledger.

The port's copy of the RL part of ray_tpu/util/profiler.py:
`RL_COMPONENTS`, `rl_ledger` and `rl_ledger_from_samples` (with
`_family_sums`), which rl/online.py times its iterations into and the
rl_sync_stall health rule reads through the rl_sync_stall_fraction gauge.
The rest of the reference's module (stack dumps, sampling profiles,
device-memory accounting, the cluster goodput ledger and the alert-driven
stack dump) waits for ROADMAP A5c.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["RL_COMPONENTS", "rl_ledger", "rl_ledger_from_samples"]

RL_COMPONENTS = ("rollout", "reward", "train", "weight_sync")


def rl_ledger(wall_s: float, rollout_s: float = 0.0, reward_s: float = 0.0,
              train_s: float = 0.0,
              weight_sync_s: float = 0.0) -> Dict[str, float]:
    """Online-RL decomposition of one loop iteration's wall time into
    the RL_COMPONENTS (+ 'other' — coordination the four phases don't
    cover), an exact partition: the <5% sync-stall claim reads
    sync_stall_fraction straight off this, measured, not asserted.
    Phases timed on concurrent threads can over-count; they are scaled
    down proportionally (overcommit reported) so the ledger stays a
    partition."""
    wall_s = max(float(wall_s), 0.0)
    parts = {
        "rollout": max(float(rollout_s), 0.0),
        "reward": max(float(reward_s), 0.0),
        "train": max(float(train_s), 0.0),
        "weight_sync": max(float(weight_sync_s), 0.0),
    }
    spent = sum(parts.values())
    overcommit = max(0.0, spent - wall_s)
    if overcommit > 0.0 and spent > 0.0:
        scale = wall_s / spent
        parts = {k: v * scale for k, v in parts.items()}
        spent = wall_s
    return {"wall_seconds": wall_s, **parts,
            "other": wall_s - spent,
            "overcommit_seconds": overcommit,
            "sync_stall_fraction": (parts["weight_sync"] / wall_s
                                    if wall_s > 0 else 0.0)}


def _family_sums(families: List[Dict[str, Any]]) -> Dict[str, float]:
    """Fold a metrics snapshot (registry.snapshot() families, possibly
    merged across nodes) into {family_name: summed value}; histograms
    contribute their _sum series."""
    out: Dict[str, float] = {}
    for fam in families or []:
        name = fam.get("name", "")
        for sname, _tags, value in fam.get("samples", []):
            if sname == name or sname == f"{name}_sum":
                out[name] = out.get(name, 0.0) + float(value)
    return out


def rl_ledger_from_samples(families: List[Dict[str, Any]],
                           wall_s: Optional[float] = None
                           ) -> Dict[str, float]:
    """Build the rl ledger from the rl_phase_seconds{phase=...} family
    rl/online.py exports. Wall defaults to the phases' sum (the loop is
    sequential per iteration); pass the measured wall for a loop that
    overlaps rollout with training."""
    phase: Dict[str, float] = {}
    for fam in families or []:
        if fam.get("name") != "rl_phase_seconds":
            continue
        for sname, tags, value in fam.get("samples", []):
            if sname in ("rl_phase_seconds", "rl_phase_seconds_sum"):
                p = dict(tags or {}).get("phase", "")
                phase[p] = phase.get(p, 0.0) + float(value)
    if wall_s is None:
        wall_s = sum(phase.get(p, 0.0) for p in RL_COMPONENTS)
    return rl_ledger(
        wall_s,
        rollout_s=phase.get("rollout", 0.0),
        reward_s=phase.get("reward", 0.0),
        train_s=phase.get("train", 0.0),
        weight_sync_s=phase.get("weight_sync", 0.0),
    )

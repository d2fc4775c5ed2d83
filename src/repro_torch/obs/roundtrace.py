"""Host-side view of the engine's round trace (a copy of the JAX package's
`obs/roundtrace.py`; numpy only).

`core/engine.py` writes per-round diagnostics into preallocated buffers
inside the round loop (the `EngineTrace` carry slot); `fleet/solve.py`
gathers and trims them exactly like the J history and wraps the numpy
arrays in the `FleetTrace` below, the object `FleetResult.trace` exposes.

All `[B, m_max + 1]` buffers obey the history contract (DESIGN.md
sections 11 and 14): column m holds round m's value for every instance the
round was applied to, and stays at its NaN (or, for `live`, 0.0) init value
past each instance's freeze point, so the NaN mask doubles as the
per-instance convergence record, and frozen lanes are bitwise-independent
of how long the rest of the batch kept the loop alive.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FleetTrace:
    """Per-round, per-instance solver diagnostics of one fleet solve.

    J_comm / J_comp : [B, m_max + 1] objective split per applied round
                      (column 0 = structured init), NaN past freeze
    moves           : [B, m_max + 1] placement churn — how many live
                      (app, partition) hosts changed in the round; column 0
                      is 0.0 (the init has no previous placement), NaN past
                      freeze
    live            : [B, m_max + 1] 1.0 iff the round was applied to the
                      instance (`live[b, m] == 1  <=>  m <= iters[b]`);
                      the other buffers' NaN mask in arithmetic form
    best_round      : [B] int32 round index of the returned best iterate
                      (0 = the structured init was never improved on)
    """

    J_comm: np.ndarray
    J_comp: np.ndarray
    moves: np.ndarray
    live: np.ndarray
    best_round: np.ndarray

    @property
    def n_instances(self) -> int:
        return int(self.live.shape[0])

    @property
    def n_rounds(self) -> int:
        """Last round applied to ANY instance (= FleetResult.rounds)."""
        applied = np.flatnonzero(self.live.sum(axis=0) > 0)
        return int(applied[-1]) if applied.size else 0

    def churn_per_instance(self) -> np.ndarray:
        """[B] mean placement moves per applied round (0.0 for instances
        that froze immediately and never applied a round)."""
        moves = self.moves[:, 1:]
        applied = ~np.isnan(moves)
        counts = applied.sum(axis=1)
        total = np.where(applied, moves, 0.0).sum(axis=1)
        return np.where(counts > 0, total / np.maximum(counts, 1), 0.0)

    def mean_churn(self) -> float:
        """Mean placement moves per applied round over the whole fleet."""
        moves = self.moves[:, 1:]
        if not np.any(~np.isnan(moves)):
            return 0.0
        return float(np.nanmean(moves))

    def frozen_count(self) -> np.ndarray:
        """[n_rounds + 1] instances NOT applied at each executed round —
        the paper-facing \"how much of the fleet had converged by round m\"
        curve (column 0 is always 0: the init applies to everyone)."""
        cols = self.n_rounds + 1
        return (self.live[:, :cols] <= 0.0).sum(axis=0).astype(np.int64)

    def to_dict(self) -> dict:
        """Compact JSON-ready summary (what the launch CLI emits)."""
        return {
            "rounds": self.n_rounds,
            "mean_churn_per_round": round(self.mean_churn(), 4),
            "churn_per_instance": [
                round(float(c), 4) for c in self.churn_per_instance()
            ],
            "best_round": self.best_round.astype(int).tolist(),
            "frozen_count_per_round": self.frozen_count().tolist(),
        }

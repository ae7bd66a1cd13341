"""Communication-latency regressor — the comm half of every predictor
backend (paper §V-D: RF on a profiled-collective database; here a
relative-error-weighted alpha-beta regression per (op, participants)
bucket fitted on profiled ``hwsim.simulate_comm`` samples).

Moved here from ``repro_torch.core.e2e`` so backends can depend on it without
pulling in the workload generator; ``repro_torch.core.e2e`` re-exports it for
backward compatibility.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import hwsim
from repro_torch.core.hardware import TPUSpec


class CommRegressor:
    """Per (op, participant-count) bucket, fit latency = alpha + beta*bytes
    on profiled samples — the standard alpha-beta structure.

    ``OPS`` is the fitted collective vocabulary; it includes the
    expert-parallel ``all_to_all`` (MoE dispatch/combine, ISSUE 5).
    Regressors fitted before that op existed raise an actionable
    RuntimeError naming their fitted ops when asked for it — the error
    ``FleetRouter`` surfaces as a per-hardware skip warning."""

    #: collectives ``fit`` profiles (must cover every op the workload
    #: generator emits — see ``core.e2e.layer_calls``/``request_calls``)
    OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "p2p")

    def __init__(self) -> None:
        self.theta: dict = {}

    _NS = (2, 4, 8, 16)

    def fitted_ops(self) -> list:
        """Sorted op names this regressor has coefficients for."""
        return sorted({op for op, _ in self.theta})

    def fit(self, hw: TPUSpec, seed: int = 0) -> "CommRegressor":
        rng = np.random.default_rng(seed)
        for op in self.OPS:
            for n in self._NS:
                rows, ys = [], []
                for _ in range(60):
                    nbytes = float(np.exp(rng.uniform(np.log(1e3), np.log(1e9))))
                    t = hwsim.simulate_comm(op, nbytes, n, hw)
                    rows.append([1.0, nbytes])
                    ys.append(t)
                A = np.asarray(rows)
                y = np.asarray(ys)
                # weight by 1/t: minimize *relative* error so the alpha
                # (latency) regime isn't drowned out by GB-sized samples
                Aw = A / y[:, None]
                self.theta[(op, n)], *_ = np.linalg.lstsq(Aw, np.ones_like(y), rcond=None)
        return self

    def predict(self, op: str, nbytes: float, n: int) -> float:
        if not self.theta:
            raise RuntimeError(
                "CommRegressor has no fitted coefficients (fitted ops: "
                "none) — call fit(hw) first"
            )
        if n <= 1 or nbytes <= 0:
            return 0.0
        nb = min(self._NS, key=lambda x: abs(math.log(x) - math.log(max(n, 2))))
        if (op, nb) not in self.theta:
            raise RuntimeError(
                f"CommRegressor has no coefficients for comm op {op!r} "
                f"(fitted ops: {self.fitted_ops()}) — call fit(hw) to "
                f"refit; regressors fitted before an op joined "
                f"CommRegressor.OPS (e.g. the EP 'all_to_all') must be "
                f"refitted to price it"
            )
        a, b = self.theta[(op, nb)]
        return float(max(a + b * nbytes, 1e-7))

"""Knowledge Base + provenance (paper §II-C).

The KB stores, per (parameter, context), the estimated threshold above which
migrating a cell pays off (seeded by an expert, updated by Algorithm 2), plus
PROV-ML-lite provenance records of every cell execution and migration
decision ("Notebook to Knowledge Base" service / ProvLake stand-in).
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ParamEstimate:
    param: str
    threshold: float
    valid_range: tuple[float, float] = (0.0, float("inf"))
    source: str = "expert"           # expert | learned
    history: list[float] = field(default_factory=list)
    # EWMA coefficient for updates: None keeps the paper's behaviour (the
    # last observation overwrites the threshold); 0 < smoothing <= 1 blends
    # each new observation into the running estimate so one noisy probe run
    # can't swing the migration threshold wholesale.
    smoothing: float | None = None

    def update(self, value: float) -> None:
        lo, hi = self.valid_range
        v = float(min(max(value, lo), hi))
        if self.smoothing is not None and self.source == "learned":
            v = self.smoothing * v + (1.0 - self.smoothing) * self.threshold
            v = float(min(max(v, lo), hi))
        self.threshold = v
        self.source = "learned"
        self.history.append(self.threshold)


@dataclass
class ProvRecord:
    """PROV-ML-lite: Activity (cell run) + Agent (env) + used/generated."""
    kind: str                         # cell-run | migration | kb-update
    cell_id: str | None
    env: str | None
    started: float
    ended: float
    params: dict[str, Any] = field(default_factory=dict)
    used: tuple[str, ...] = ()
    generated: tuple[str, ...] = ()
    decision: str | None = None
    reason: str | None = None


class KnowledgeBase:
    def __init__(self):
        self._params: dict[str, ParamEstimate] = {}
        self.provenance: list[ProvRecord] = []

    # --- parameter estimates (knowledge-aware policy) ------------------
    def seed(self, param: str, threshold: float,
             valid_range: tuple[float, float] = (0.0, float("inf")),
             smoothing: float | None = None) -> None:
        self._params[param] = ParamEstimate(param, threshold, valid_range,
                                            smoothing=smoothing)

    def get_known_parameters(self) -> list[str]:
        return list(self._params)

    def get(self, param: str) -> ParamEstimate | None:
        return self._params.get(param)

    def update(self, param: str, value: float) -> None:
        if param not in self._params:
            self._params[param] = ParamEstimate(param, value, source="learned")
        else:
            self._params[param].update(value)
        self.record(ProvRecord("kb-update", None, None, time.time(), time.time(),
                               params={param: value}))

    # --- provenance -----------------------------------------------------
    def record(self, rec: ProvRecord) -> None:
        self.provenance.append(rec)

    def records(self, kind: str | None = None) -> list[ProvRecord]:
        return [r for r in self.provenance if kind is None or r.kind == kind]

    def record_prediction(self, cell_id: str | None, notebook: str,
                          predicted: dict[int, float], realized: int,
                          when: float = 0.0) -> ProvRecord:
        """Record predicted next-cell distribution vs the realized next cell
        (the calibration signal the prefetch confidence gate learns from).
        Only the top few candidates are kept so provenance stays bounded."""
        top = sorted(predicted.items(), key=lambda kv: (-kv[1], kv[0]))[:5]
        rec = ProvRecord(
            "prediction", cell_id, None, when, when,
            params={"notebook": notebook,
                    "predicted": [[int(c), float(p)] for c, p in top],
                    "realized": int(realized),
                    "hit": bool(top and top[0][0] == realized),
                    "prob_realized": float(predicted.get(realized, 0.0))})
        self.record(rec)
        return rec

    def export_json(self, max_records: int = 1000, *,
                    kind: str | None = None, indent: int | None = None) -> str:
        """Bounded JSON export of provenance: the ``max_records`` most
        recent records (optionally one kind), with non-JSON-native values
        coerced via ``str`` so arbitrary params can't break the export."""
        max_records = max(0, int(max_records))
        recs = self.records(kind)[-max_records:] if max_records else []
        payload = {
            "params": {p: {"threshold": e.threshold, "source": e.source,
                           "smoothing": e.smoothing,
                           "history": list(e.history)}
                       for p, e in sorted(self._params.items())},
            "records": [dataclasses.asdict(r) for r in recs],
            "total_records": len(self.provenance),
            "exported_records": len(recs),
        }
        return json.dumps(payload, default=str, indent=indent)

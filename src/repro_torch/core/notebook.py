"""Cells and notebooks (a minimal, faithful Notebook Document Format model).

Cells carry real Python source (executed with ``exec`` against the session's
ExecutionState), an optional simulated base cost (the paper's §III protocol
forces cell times), and the explainability annotations the tool attaches
("cells are automatically annotated with explainability on cell migration
decisions")."""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field


@dataclass
class Cell:
    source: str
    cell_type: str = "code"          # code | markdown | raw
    cell_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    cost: float | None = None        # simulated base (local) seconds
    annotations: list[str] = field(default_factory=list)

    def annotate(self, note: str) -> None:
        self.annotations.append(note)


class Notebook:
    def __init__(self, name: str, cells: list[Cell] | None = None,
                 path: str = ""):
        self.name = name
        self.path = path or f"{name}.ipynb"
        self.cells: list[Cell] = list(cells or [])

    # ------------------------------------------------------------------
    def add_cell(self, source: str, **kw) -> Cell:
        cell = Cell(source=source, **kw)
        self.cells.append(cell)
        return cell

    def order(self, cell_id: str) -> int:
        for i, c in enumerate(self.cells):
            if c.cell_id == cell_id:
                return i
        raise KeyError(cell_id)

    def cell(self, ref) -> Cell:
        if isinstance(ref, int):
            return self.cells[ref]
        return self.cells[self.order(ref)]

    def cell_ids(self) -> tuple[str, ...]:
        return tuple(c.cell_id for c in self.cells)

    def code_cells(self) -> list[Cell]:
        """The extension only operates on code cells (§II-A)."""
        return [c for c in self.cells if c.cell_type == "code"]

    # ------------------------------------------------------------------
    def to_ipynb(self) -> dict:
        return {
            "nbformat": 4, "nbformat_minor": 5,
            "metadata": {"name": self.name},
            "cells": [{"id": c.cell_id, "cell_type": c.cell_type,
                       "source": c.source,
                       "metadata": {"repro": {"cost": c.cost,
                                              "annotations": c.annotations}}}
                      for c in self.cells],
        }

    @classmethod
    def from_ipynb(cls, doc: dict, name: str = "nb") -> "Notebook":
        nb = cls(doc.get("metadata", {}).get("name", name))
        for c in doc["cells"]:
            meta = c.get("metadata", {}).get("repro", {})
            src = c["source"]
            if isinstance(src, list):
                src = "".join(src)
            nb.cells.append(Cell(source=src, cell_type=c.get("cell_type", "code"),
                                 cell_id=c.get("id", str(uuid.uuid4())),
                                 cost=meta.get("cost"),
                                 annotations=list(meta.get("annotations", []))))
        return nb

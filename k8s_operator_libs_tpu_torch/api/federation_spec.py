"""Federation-policy API types — the fleet-of-fleets CRD fragment.

Millions of users means many clusters, not one big one.  The single
cluster policy (:mod:`.upgrade_spec`) bounds a rollout inside one
cluster; a :class:`FederationPolicySpec` bounds a rollout ACROSS
clusters: an ordered list of **cells** (canary cluster → region →
global), each a whole cluster treated as one admission unit, plus a
**global breaker** that rolls per-cell failure budgets up into one
fleet-wide circuit.

The cell model deliberately reuses the single-cluster vocabulary at
cluster granularity:

* ``soakSeconds`` is ``canarySoakSeconds`` for a whole cluster — a cell
  whose rollout completed still bakes before the next cell admits;
* ``advanceOn`` reuses the ANALYSIS condition grammar
  (:func:`.upgrade_spec.parse_analysis_condition`) evaluated over the
  CELL's own SLO report (``burn:<slo>``, ``stragglers``, ``eta``,
  ``breaches``, ``phase_p*:<phase>``) and sustained via the
  coordinator's per-cell metrics-history ring, exactly like an
  analysis step's ``advanceOn`` inside one cluster;
* the global breaker is :class:`~.upgrade_spec.RemediationSpec`'s
  failure-budget census with CLUSTERS as the attribution unit: a cell
  is *breached* when its local breaker/abort stands open or its own
  failed/attempted ratio crosses ``cellFailureThreshold``, and the
  global breaker opens when ``maxBreachedCells`` cells are breached or
  the AGGREGATE cross-cluster ratio crosses ``failureThreshold``.

Serialized with the same camelCase convention as the upgrade policy so
the standalone CRD (crd/nvidia.com_gpufederationpolicies.yaml)
round-trips byte-compatibly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from .upgrade_spec import (
    ValidationError,
    _require_bool,
    _require_non_negative,
    parse_analysis_condition,
)


@dataclass
class FederationCellSpec:
    """One cell (cluster) in the federation rollout order."""

    #: Cell name — the audit-plane identity (decision targets read
    #: ``cell:<name>``, merged streams tag decisions with it).
    name: str = ""
    #: Bake window after the cell's rollout COMPLETES before the cell
    #: may promote (the cluster-granular canarySoakSeconds).  0 = none.
    soak_seconds: float = 0.0
    #: Analysis-grammar condition strings over the cell's SLO report;
    #: ALL must hold (sustained per their ``for Ns`` clause) for the
    #: cell to promote.  Empty = promote on completion + soak alone.
    advance_on: tuple = ()

    def __post_init__(self) -> None:
        if isinstance(self.advance_on, str):
            raise ValidationError(
                "federation cell advanceOn must be a list of condition "
                f"strings, got the string {self.advance_on!r}"
            )
        self.advance_on = tuple(self.advance_on or ())

    def parsed_advance(self) -> tuple:
        return tuple(parse_analysis_condition(c) for c in self.advance_on)

    def validate(self) -> None:
        if not isinstance(self.name, str) or not self.name:
            raise ValidationError("federation cell name must be non-empty")
        if "/" in self.name:
            # '/' is the merged-stream "cell/target" separator
            raise ValidationError(
                f"federation cell name {self.name!r} must not contain '/'"
            )
        if self.name == "federation":
            # the coordinator's OWN stream key in the merged audit
            # trail — a cell by this name would silently shadow it
            raise ValidationError(
                "federation cell name 'federation' is reserved for the "
                "coordinator's own decision stream"
            )
        _require_non_negative(
            "federation.cells[].soakSeconds", self.soak_seconds
        )
        self.parsed_advance()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name}
        if self.soak_seconds:
            out["soakSeconds"] = self.soak_seconds
        if self.advance_on:
            out["advanceOn"] = list(self.advance_on)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FederationCellSpec":
        return cls(
            name=d.get("name", ""),
            soak_seconds=d.get("soakSeconds", 0.0),
            advance_on=tuple(d.get("advanceOn") or ()),
        )


@dataclass
class GlobalBreakerSpec:
    """Cross-cluster failure-budget rollup (the fleet-of-fleets
    breaker).  All knobs compose with each cell's OWN remediation
    block — the global breaker is a second, coarser circuit layered
    over the per-cluster ones, never a replacement."""

    #: Breached cells that open the global breaker (a breached cell =
    #: local breaker/abort open, or its own ratio over
    #: ``cellFailureThreshold``).
    max_breached_cells: int = 1
    #: Aggregate failed/attempted ratio ACROSS all cells that opens the
    #: breaker (0 < threshold <= 1), once ``minAttempted`` nodes were
    #: attempted fleet-wide inside ``windowSeconds``.
    failure_threshold: float = 0.25
    min_attempted: int = 3
    window_seconds: float = 3600.0
    #: Per-cell failed/attempted ratio that marks the CELL breached.
    cell_failure_threshold: float = 0.5
    cell_min_attempted: int = 1
    #: On global trip, drive the existing trip/LKG-rollback machinery
    #: (``RemediationManager.trip_for_slo``) in each BREACHED cell, so
    #: it reverts to its last-known-good revision.  Needs the cell
    #: policy to carry a remediation block with ``autoRollback``.
    rollback_breached: bool = True
    #: Also trip already-PROMOTED cells still running the target (the
    #: blast-radius-zero stance: a fleet-wide burn means the promoted
    #: cells are running the same bad build).  Default off — promoted
    #: cells passed their own gates.
    rollback_promoted: bool = False

    def validate(self) -> None:
        _require_bool(
            "federation.globalBreaker.rollbackBreached",
            self.rollback_breached,
        )
        _require_bool(
            "federation.globalBreaker.rollbackPromoted",
            self.rollback_promoted,
        )
        if self.max_breached_cells < 1:
            raise ValidationError(
                "federation.globalBreaker.maxBreachedCells must be >= 1, "
                f"got {self.max_breached_cells!r}"
            )
        for label, value in (
            ("failureThreshold", self.failure_threshold),
            ("cellFailureThreshold", self.cell_failure_threshold),
        ):
            if not (0.0 < float(value) <= 1.0):
                raise ValidationError(
                    f"federation.globalBreaker.{label} must be in (0, 1], "
                    f"got {value!r}"
                )
        _require_non_negative(
            "federation.globalBreaker.minAttempted", self.min_attempted
        )
        _require_non_negative(
            "federation.globalBreaker.cellMinAttempted",
            self.cell_min_attempted,
        )
        if self.window_seconds <= 0:
            raise ValidationError(
                "federation.globalBreaker.windowSeconds must be > 0, got "
                f"{self.window_seconds!r}"
            )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.max_breached_cells != 1:
            out["maxBreachedCells"] = self.max_breached_cells
        if self.failure_threshold != 0.25:
            out["failureThreshold"] = self.failure_threshold
        if self.min_attempted != 3:
            out["minAttempted"] = self.min_attempted
        if self.window_seconds != 3600.0:
            out["windowSeconds"] = self.window_seconds
        if self.cell_failure_threshold != 0.5:
            out["cellFailureThreshold"] = self.cell_failure_threshold
        if self.cell_min_attempted != 1:
            out["cellMinAttempted"] = self.cell_min_attempted
        if not self.rollback_breached:
            out["rollbackBreached"] = False
        if self.rollback_promoted:
            out["rollbackPromoted"] = True
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GlobalBreakerSpec":
        return cls(
            max_breached_cells=d.get("maxBreachedCells", 1),
            failure_threshold=d.get("failureThreshold", 0.25),
            min_attempted=d.get("minAttempted", 3),
            window_seconds=d.get("windowSeconds", 3600.0),
            cell_failure_threshold=d.get("cellFailureThreshold", 0.5),
            cell_min_attempted=d.get("cellMinAttempted", 1),
            rollback_breached=d.get("rollbackBreached", True),
            rollback_promoted=d.get("rollbackPromoted", False),
        )


@dataclass
class FederationPolicySpec:
    """The fleet-of-fleets rollout policy: cell order + target + the
    global breaker.  Consumed by
    :class:`~..federation.FederationCoordinator` — one coordinator,
    N unchanged per-cluster managers behind the backend-agnostic
    ``ClusterClient`` protocol."""

    #: Federation name (the coordinator's record identity).
    name: str = "default"
    #: Ordered cells: cells[0] is the canary cluster; a cell admits
    #: only when every earlier cell has PROMOTED.
    cells: tuple = ()
    #: ControllerRevision hash the coordinator publishes into each cell
    #: at admission (the cross-cluster analog of a DS template bump).
    target_revision: str = ""
    global_breaker: GlobalBreakerSpec = field(
        default_factory=GlobalBreakerSpec
    )

    def __post_init__(self) -> None:
        if isinstance(self.cells, (str, dict)):
            raise ValidationError(
                f"federation.cells must be a list of cells, got "
                f"{self.cells!r}"
            )
        self.cells = tuple(
            c
            if isinstance(c, FederationCellSpec)
            else FederationCellSpec.from_dict(c)
            for c in (self.cells or ())
        )
        if isinstance(self.global_breaker, dict):
            self.global_breaker = GlobalBreakerSpec.from_dict(
                self.global_breaker
            )

    def cell_names(self) -> tuple:
        return tuple(c.name for c in self.cells)

    def validate(self) -> None:
        if not isinstance(self.name, str) or not self.name:
            raise ValidationError("federation name must be non-empty")
        if not self.cells:
            raise ValidationError(
                "federation declares no cells — at least one is required"
            )
        names = set()
        for cell in self.cells:
            cell.validate()
            if cell.name in names:
                raise ValidationError(
                    f"federation cell name {cell.name!r} is not unique"
                )
            names.add(cell.name)
        if not isinstance(self.target_revision, str) or not self.target_revision:
            raise ValidationError(
                "federation.targetRevision must name the ControllerRevision "
                "hash the wave rolls out"
            )
        self.global_breaker.validate()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "cells": [c.to_dict() for c in self.cells],
            "targetRevision": self.target_revision,
        }
        breaker = self.global_breaker.to_dict()
        if breaker:
            out["globalBreaker"] = breaker
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FederationPolicySpec":
        return cls(
            name=d.get("name", "default"),
            cells=tuple(
                FederationCellSpec.from_dict(c) for c in d.get("cells") or ()
            ),
            target_revision=d.get("targetRevision", ""),
            global_breaker=(
                GlobalBreakerSpec.from_dict(d["globalBreaker"])
                if d.get("globalBreaker") is not None
                else GlobalBreakerSpec()
            ),
        )

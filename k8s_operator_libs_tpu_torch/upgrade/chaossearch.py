"""Coverage-guided chaos: search the fault space instead of enumerating it.

The campaign engine (``chaos.py``) sweeps a FIXED 42-cell matrix; its
rollout-invariant checker is far stronger than the scenario generator
feeding it.  This module turns the enumerator into a searcher — the
same jump coverage-guided fuzzers made over fixed test suites:

* **Mutate** — a catalog of serializable mutation operators rewrites
  campaign cell parameters: composed fault stacks through the
  ``FaultSpec``/``with_faults`` partial-update seam (drop ratios,
  latency, held-stream truncation, mid-scenario fault clears,
  targeted partition windows), live policy-edit contents, fault
  timing shifts, federated outage/hold timing, and the axis combo
  itself (transport x gates x driver, fleet size).
* **Score** — each run is graded by *proximity to an invariant
  violation* using the checker's fitness signals
  (``chaos.FITNESS_SIGNALS``): budget headroom at settled points,
  breaker margin, audit-continuity near-gap width, decision-stream
  anomaly counts, stream-parity slack.  A violation dominates every
  graded signal (``fitness_score`` > 1.0).
* **Shrink** — any failing cell feeds a delta-debugging shrinker
  (greedy operator removal, then per-operator numeric shrinking, then
  fleet-size reduction) that emits a minimal deterministic reproducer.
* **Ratchet** — reproducers are appended to a regression-cell file
  that the default campaign replays after the 42-cell matrix, so the
  campaign only ever grows teeth.

Determinism is the hard constraint.  A searched cell replays
byte-identical from ``(campaign_seed, scenario, mutation-vector,
seed)`` alone: mutation vectors are plain JSON data (canonicalized by
``chaos.mutation_vector_key``) folded into ``chaos.cell_seed``, the
search RNG is seeded from the config, and no hook reads ambient
entropy (wall clocks, ``random`` module state, PYTHONHASHSEED).

``selftest()`` is the self-proving end-to-end demo wired into ``make
verify-chaos-search``: it plants a known invariant bug (an external
cordon storm whose blast radius scales with a ``stress`` param),
shows gen-0 fitness below the violation line, lets the searcher climb
to the violation, shrinks it to the single ``stress`` operator,
replays the reproducer byte-identically twice, ratchets it (42 ->
>=43 cells), then "fixes" the bug and proves the ratcheted cell
replays green.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import time
import zlib
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..api.upgrade_spec import IntOrString, UpgradePolicySpec
from ..cluster.apiserver import FAULT_KINDS, FaultSpec
from ..cluster.errors import ApiError
from . import chaos

#: the shipped ratchet file: regression cells the DEFAULT campaign
#: replays after the matrix (the CLI and bench attach it explicitly;
#: ``Campaign.regression_cells`` itself defaults empty so handmade
#: mini-campaigns in tests are unaffected); it ships inside the package
DEFAULT_REGRESSIONS_PATH = (
    Path(__file__).resolve().parents[1] / "hack" / "chaos_regressions.json"
)


def candidate_key(candidate: dict) -> str:
    """Canonical identity of a search candidate (sorted-key JSON):
    the dedupe/caching key and the collision-assertion witness."""
    return json.dumps(candidate, sort_keys=True, separators=(",", ":"))


def _clamp(value, lo, hi):
    return max(lo, min(hi, value))


def _with_op(name: str, params: dict) -> dict:
    return {"op": name, **params}


# --------------------------------------------------------------------------
# Mutation operators.
#
# An operator is pure data + four pure functions: whether it applies
# to a (scenario, candidate), how to sample fresh parameters, how to
# perturb existing ones, how to propose smaller ones (for the
# shrinker) — plus ``install``, which compiles the serialized params
# into scenario hooks at run time.  Parameters are plain JSON values;
# nothing about an operator instance is stateful, so the same vector
# always derives the same scenario.
# --------------------------------------------------------------------------
class _Hooks:
    """Accumulator ``install`` writes into: extra setup/tick closures
    layered after the base scenario's own, a tick-shift offset, and
    scenario param overrides (the ``Scenario.params`` seam)."""

    def __init__(self, params: dict):
        self.setups: List[Callable] = []
        self.ticks: List[Callable] = []
        self.tick_shift = 0
        self.params = params


@dataclass(frozen=True)
class MutationOperator:
    name: str
    description: str
    applies: Callable  # (scenario, candidate) -> bool
    sample: Callable  # (rng) -> params
    install: Callable  # (hooks, mutation) -> None
    perturb: Optional[Callable] = None  # (rng, params) -> params
    shrink: Optional[Callable] = None  # (params) -> [params, ...]


def _http_cell(scenario, candidate) -> bool:
    return (
        candidate.get("transport") == "http" and scenario.runner is None
    )


# ---- chaos-drop: random request drops through the FaultSpec seam
def _install_chaos_drop(hooks, m) -> None:
    ratio = float(m["ratio"])

    def _setup(cell) -> None:
        FaultSpec(
            chaos_drop_ratio=ratio, chaos_seed=cell.seed
        ).apply(cell.facade)

    hooks.setups.append(_setup)


# ---- latency: per-request stalls (seeded jitter)
def _install_latency(hooks, m) -> None:
    seconds = int(m["ms"]) / 1000.0

    def _setup(cell) -> None:
        FaultSpec(
            request_latency_seconds=seconds, latency_seed=cell.seed
        ).apply(cell.facade)

    hooks.setups.append(_setup)


# ---- held-frames: tighten held-stream truncation
def _install_held_frames(hooks, m) -> None:
    frames = int(m["frames"])

    def _setup(cell) -> None:
        FaultSpec(held_stream_max_frames=frames).apply(cell.facade)

    hooks.setups.append(_setup)


# ---- fault-clear: retract ONE fault kind mid-scenario (the composed
# partial-clear seam the FaultSpec fix hardens: sibling kinds keep
# firing and no counter resets)
def _install_fault_clear(hooks, m) -> None:
    at = int(m["cycle"])
    kind = str(m["kind"])

    def _tick(cell, cycle: int) -> None:
        if cycle == at:
            cell.facade.clear_fault_kind(kind)

    hooks.ticks.append(_tick)


# ---- partition-window: an extra targeted partition window, chained
# in FRONT of any partition hook the base scenario installed
def _install_partition_window(hooks, m) -> None:
    at = int(m["cycle"])
    budget = int(m["budget"])
    node = m.get("node")
    target = None if node is None else f"c{int(node):03d}"
    state = {"left": 0}

    def _setup(cell) -> None:
        state["left"] = 0  # a derived scenario may be run repeatedly
        prev = cell.facade._handler_cls.partition_hook

        def hook(method, info, namespace, name, query) -> bool:
            if (
                state["left"] > 0
                and info.kind in ("Pod", "Node")
                and (target is None or target in (name or ""))
            ):
                state["left"] -= 1
                return True
            return bool(
                prev and prev(method, info, namespace, name, query)
            )

        cell.facade.with_faults(partition_hook=hook)

    def _tick(cell, cycle: int) -> None:
        if cycle == at:
            state["left"] = budget

    hooks.setups.append(_setup)
    hooks.ticks.append(_tick)


# ---- tick-shift: delay the base scenario's own fault timeline
def _install_tick_shift(hooks, m) -> None:
    hooks.tick_shift += int(m["delta"])


# ---- policy-edit: a live mid-rollout policy rewrite.  auto_upgrade
# stays True and remediation/drain/SLOs are PRESERVED so the mutation
# probes budget handling without retracting the scenario's own
# expectations (a disabled breaker would "find" non-bugs).
def _install_policy_edit(hooks, m) -> None:
    at = int(m["cycle"])
    max_unavailable = m["max_unavailable"]
    max_parallel = int(m["max_parallel"])

    def _tick(cell, cycle: int) -> None:
        if cycle != at:
            return
        current = cell.policy
        kwargs = dict(
            auto_upgrade=True,
            max_parallel_upgrades=max_parallel,
            max_unavailable=IntOrString(max_unavailable),
            drain_spec=current.drain_spec,
        )
        if getattr(current, "remediation", None) is not None:
            kwargs["remediation"] = current.remediation
        if getattr(current, "slos", None) is not None:
            kwargs["slos"] = current.slos
        edited = UpgradePolicySpec(**kwargs)
        cell.policy = edited
        cell.audit.note_policy_change(edited)
        cell.notes["policy_edits"] = (
            cell.notes.get("policy_edits", 0) + 1
        )

    hooks.ticks.append(_tick)


# ---- param rewrites: scenario tunables read by runner/tick hooks
def _install_stress(hooks, m) -> None:
    hooks.params["stress"] = int(m["level"])


def _install_fed_outage(hooks, m) -> None:
    hooks.params["outage_cycles"] = int(m["cycles"])


def _install_fed_hold(hooks, m) -> None:
    hooks.params["hold_ticks"] = int(m["ticks"])


OPERATORS: Dict[str, MutationOperator] = {
    op.name: op
    for op in (
        MutationOperator(
            name="chaos-drop",
            description="random request drops + abrupt closes (seeded)",
            applies=_http_cell,
            sample=lambda rng: {
                "ratio": round(0.02 + 0.03 * rng.randrange(5), 4)
            },
            perturb=lambda rng, p: {
                "ratio": _clamp(
                    round(
                        p["ratio"]
                        * (0.5 if rng.random() < 0.5 else 1.5),
                        4,
                    ),
                    0.01,
                    0.3,
                )
            },
            shrink=lambda p: (
                [{"ratio": round(p["ratio"] / 2, 4)}]
                if p["ratio"] > 0.02
                else []
            ),
            install=_install_chaos_drop,
        ),
        MutationOperator(
            name="latency",
            description="per-request latency in milliseconds (seeded)",
            applies=_http_cell,
            sample=lambda rng: {"ms": rng.randint(1, 4)},
            perturb=lambda rng, p: {
                "ms": _clamp(p["ms"] + rng.choice((-1, 1)), 1, 10)
            },
            shrink=lambda p: (
                [{"ms": p["ms"] - 1}] if p["ms"] > 1 else []
            ),
            install=_install_latency,
        ),
        MutationOperator(
            name="held-frames",
            description="held watch streams reset every N frames",
            applies=lambda s, c: (
                _http_cell(s, c) and s.client_mode == "held"
            ),
            sample=lambda rng: {"frames": rng.randint(2, 6)},
            perturb=lambda rng, p: {
                "frames": _clamp(
                    p["frames"] + rng.choice((-1, 1)), 2, 12
                )
            },
            install=_install_held_frames,
        ),
        MutationOperator(
            name="fault-clear",
            description="clear one fault kind at a chosen cycle "
            "(composed partial-clear seam)",
            applies=_http_cell,
            sample=lambda rng: {
                "cycle": rng.randint(2, 9),
                "kind": rng.choice(FAULT_KINDS),
            },
            perturb=lambda rng, p: {
                "cycle": _clamp(p["cycle"] + rng.choice((-1, 1)), 1, 12),
                "kind": p["kind"],
            },
            install=_install_fault_clear,
        ),
        MutationOperator(
            name="partition-window",
            description="an extra Pod/Node partition window, "
            "optionally targeting one node",
            applies=_http_cell,
            sample=lambda rng: {
                "cycle": rng.randint(1, 6),
                "budget": rng.choice((6, 12, 18)),
                "node": (
                    rng.randint(0, 5) if rng.random() < 0.5 else None
                ),
            },
            perturb=lambda rng, p: {
                **p,
                "cycle": _clamp(p["cycle"] + rng.choice((-1, 1)), 1, 10),
            },
            shrink=lambda p: [
                trial
                for trial in (
                    (
                        {**p, "budget": p["budget"] // 2}
                        if p["budget"] > 3
                        else None
                    ),
                    ({**p, "node": None} if p.get("node") is not None
                     else None),
                )
                if trial is not None
            ],
            install=_install_partition_window,
        ),
        MutationOperator(
            name="tick-shift",
            description="delay the scenario's own fault timeline by "
            "N cycles",
            applies=lambda s, c: (
                s.tick is not None and s.runner is None
            ),
            sample=lambda rng: {"delta": rng.randint(1, 3)},
            perturb=lambda rng, p: {
                "delta": _clamp(p["delta"] + rng.choice((-1, 1)), 1, 8)
            },
            shrink=lambda p: (
                [{"delta": p["delta"] - 1}] if p["delta"] > 1 else []
            ),
            install=_install_tick_shift,
        ),
        MutationOperator(
            name="policy-edit",
            description="live mid-rollout budget rewrite (remediation "
            "and drain preserved)",
            applies=lambda s, c: (
                s.runner is None and "rollback" not in (s.expect or {})
            ),
            sample=lambda rng: {
                "cycle": rng.randint(1, 8),
                "max_unavailable": rng.choice(
                    (1, 2, "25%", "50%", "100%")
                ),
                "max_parallel": rng.choice((0, 1, 2)),
            },
            perturb=lambda rng, p: {
                **p,
                "cycle": _clamp(p["cycle"] + rng.choice((-1, 1)), 1, 12),
            },
            install=_install_policy_edit,
        ),
        MutationOperator(
            name="stress",
            description="scenario stress level (Scenario.params seam)",
            applies=lambda s, c: "stress" in (s.params or {}),
            sample=lambda rng: {"level": rng.randint(0, 1)},
            perturb=lambda rng, p: {
                "level": _clamp(p["level"] + rng.choice((-1, 1)), 0, 8)
            },
            shrink=lambda p: (
                [{"level": p["level"] - 1}] if p["level"] > 0 else []
            ),
            install=_install_stress,
        ),
        MutationOperator(
            name="fed-outage",
            description="federated cell apiserver outage length",
            applies=lambda s, c: s.name == "federated-cell-failover",
            sample=lambda rng: {"cycles": rng.randint(2, 6)},
            perturb=lambda rng, p: {
                "cycles": _clamp(p["cycles"] + rng.choice((-1, 1)), 1, 10)
            },
            shrink=lambda p: (
                [{"cycles": p["cycles"] - 1}] if p["cycles"] > 1 else []
            ),
            install=_install_fed_outage,
        ),
        MutationOperator(
            name="fed-hold",
            description="federated brownout hold length in ticks",
            applies=lambda s, c: s.name == "federated-cell-brownout",
            sample=lambda rng: {"ticks": rng.randint(2, 8)},
            perturb=lambda rng, p: {
                "ticks": _clamp(p["ticks"] + rng.choice((-1, 1)), 1, 12)
            },
            shrink=lambda p: (
                [{"ticks": p["ticks"] - 1}] if p["ticks"] > 1 else []
            ),
            install=_install_fed_hold,
        ),
    )
}


# --------------------------------------------------------------------------
# Deriving a runnable Scenario from (base scenario, mutation vector).
# --------------------------------------------------------------------------
def derive_scenario(base: chaos.Scenario, mutations) -> chaos.Scenario:
    """Compile a mutation vector into a derived Scenario: the base
    setup/tick always run (evidence probes stay satisfiable), operator
    hooks layer after them, a tick-shift delays only the base
    timeline, and param rewrites land in ``Scenario.params`` (runner
    scenarios read nothing else)."""
    hooks = _Hooks(dict(base.params or {}))
    for m in mutations or []:
        OPERATORS[m["op"]].install(hooks, m)
    if not mutations:
        return base
    base_setup = base.setup
    base_tick = base.tick
    shift = hooks.tick_shift
    extra_setups = tuple(hooks.setups)
    extra_ticks = tuple(hooks.ticks)

    def setup(cell) -> None:
        if base_setup is not None:
            base_setup(cell)
        for fn in extra_setups:
            fn(cell)

    def tick(cell, cycle: int) -> None:
        if base_tick is not None and cycle - shift >= 0:
            base_tick(cell, cycle - shift)
        for fn in extra_ticks:
            fn(cell, cycle)

    return replace(
        base,
        setup=setup if (base_setup or extra_setups) else None,
        tick=tick if (base_tick or extra_ticks) else None,
        params=hooks.params,
    )


def resolve_scenarios(extra_scenarios=None) -> Dict[str, chaos.Scenario]:
    """The searcher's scenario table: the campaign catalog, this
    module's extra scenarios (the seeded selftest target), and any
    caller-provided overlay."""
    table = dict(chaos.SCENARIOS)
    table.update(EXTRA_SCENARIOS)
    if extra_scenarios:
        table.update(extra_scenarios)
    return table


def run_mutated_cell(
    campaign_seed: int, candidate: dict, extra_scenarios=None
) -> dict:
    """Run one searched cell.  The seed derives from the FULL identity
    — ``cell_seed(campaign, scenario, axes, fleet, mutations)`` — so a
    reproducer replays from the candidate dict alone."""
    table = resolve_scenarios(extra_scenarios)
    name = candidate["scenario"]
    if name not in table:
        raise ValueError(f"unknown scenario {name!r}")
    base = table[name]
    transport = candidate.get("transport", "inmem")
    gates = candidate.get("gates", "on")
    driver = candidate.get("driver", "polling")
    fleet = int(candidate.get("fleet", 5))
    vector = [dict(m) for m in (candidate.get("mutations") or [])]
    probe = dict(candidate)
    probe["transport"] = transport
    for m in vector:
        op = OPERATORS.get(m.get("op"))
        if op is None:
            raise ValueError(f"unknown mutation op {m.get('op')!r}")
        if not op.applies(base, probe):
            raise ValueError(
                f"mutation {m['op']!r} does not apply to "
                f"{name}/{transport}"
            )
    derived = derive_scenario(base, vector)
    seed = chaos.cell_seed(
        campaign_seed, name, transport, gates, fleet, driver,
        mutations=vector,
    )
    row = chaos.run_cell(
        derived, transport, gates, fleet, seed, driver=driver
    )
    row["mutations"] = [dict(m) for m in vector]
    return row


def cell_projection(row: dict) -> dict:
    """The seed-stable slice of a searched cell's row — the replay
    contract a reproducer's scorecard is asserted over (fitness rides
    along: searched cells are inmem/polling-deterministic)."""
    return {
        "scenario": row["scenario"],
        "transport": row["transport"],
        "gates": row["gates"],
        "driver": row.get("driver", "polling"),
        "fleet": row["fleet"],
        "seed": row["seed"],
        "passed": row["passed"],
        "converged": row["converged"],
        "violations": sorted(v["invariant"] for v in row["violations"]),
        "fitness_score": row.get("fitness_score", 0.0),
        "mutations": [dict(m) for m in (row.get("mutations") or [])],
    }


# --------------------------------------------------------------------------
# The generation-over-generation searcher.
# --------------------------------------------------------------------------
@dataclass
class SearchConfig:
    """Knobs for one search run.  ``seed`` doubles as the campaign
    seed every evaluated cell derives from; ``operators`` empty means
    the full catalog; ``budget_cells`` caps NEW evaluations (cached
    elites are free)."""

    seed: int = 0
    generations: int = 3
    population: int = 6
    elite: int = 2
    fleet_size: int = 5
    budget_cells: int = 48
    scenarios: Tuple[str, ...] = ()
    transports: Tuple[str, ...] = ("inmem",)
    operators: Tuple[str, ...] = ()
    mutations_max: int = 3
    stop_on_violation: bool = True


def _applicable_ops(scenario, candidate, allowed=()) -> List[str]:
    return [
        name
        for name, op in OPERATORS.items()
        if (not allowed or name in allowed)
        and op.applies(scenario, candidate)
    ]


def _random_candidate(rng, config, table, pool) -> dict:
    name = pool[rng.randrange(len(pool))]
    scenario = table[name]
    transports = [
        t for t in scenario.transports if t in config.transports
    ]
    transport = transports[rng.randrange(len(transports))]
    gates = scenario.gates[rng.randrange(len(scenario.gates))]
    drivers = [
        d
        for d in scenario.drivers
        if d == "polling" or transport == "inmem"
    ]
    driver = drivers[rng.randrange(len(drivers))]
    candidate = {
        "scenario": name,
        "transport": transport,
        "gates": gates,
        "driver": driver,
        "fleet": config.fleet_size,
        "mutations": [],
    }
    ops = _applicable_ops(scenario, candidate, config.operators)
    if ops:
        op_name = ops[rng.randrange(len(ops))]
        candidate["mutations"] = [
            _with_op(op_name, OPERATORS[op_name].sample(rng))
        ]
    return candidate


def mutate_candidate(rng, candidate, config, table) -> dict:
    """One breeding step: perturb/add/drop an operator, or flip an
    axis (gates, transport, driver, fleet).  After a transport flip,
    now-inapplicable operators are dropped."""
    child = dict(candidate)
    child["mutations"] = [dict(m) for m in candidate["mutations"]]
    scenario = table[child["scenario"]]
    actions = []
    if child["mutations"]:
        # perturbation is the gradient-following move — weight it so
        # breeding follows the fitness signal instead of drifting on
        # axis flips
        actions.extend(("perturb", "perturb", "perturb"))
    if len(child["mutations"]) < config.mutations_max and _applicable_ops(
        scenario, child, config.operators
    ):
        actions.append("add")
    if len(child["mutations"]) > 1:
        actions.append("drop")
    if len(scenario.gates) > 1:
        actions.append("gates")
    transports = [
        t for t in scenario.transports if t in config.transports
    ]
    if len(transports) > 1:
        actions.append("transport")
    if child["transport"] == "inmem" and len(scenario.drivers) > 1:
        actions.append("driver")
    actions.append("fleet")
    action = actions[rng.randrange(len(actions))]
    if action == "perturb":
        i = rng.randrange(len(child["mutations"]))
        m = child["mutations"][i]
        op = OPERATORS[m["op"]]
        params = {k: v for k, v in m.items() if k != "op"}
        params = (
            op.perturb(rng, params)
            if op.perturb is not None
            else op.sample(rng)
        )
        child["mutations"][i] = _with_op(op.name, params)
    elif action == "add":
        ops = _applicable_ops(scenario, child, config.operators)
        op_name = ops[rng.randrange(len(ops))]
        child["mutations"].append(
            _with_op(op_name, OPERATORS[op_name].sample(rng))
        )
    elif action == "drop":
        child["mutations"].pop(rng.randrange(len(child["mutations"])))
    elif action == "gates":
        child["gates"] = "off" if child["gates"] == "on" else "on"
    elif action == "transport":
        flipped = [t for t in transports if t != child["transport"]]
        child["transport"] = flipped[rng.randrange(len(flipped))]
        if child["transport"] != "inmem":
            child["driver"] = "polling"
        child["mutations"] = [
            m
            for m in child["mutations"]
            if OPERATORS[m["op"]].applies(scenario, child)
        ]
    elif action == "driver":
        child["driver"] = (
            "event" if child["driver"] == "polling" else "polling"
        )
    else:  # fleet
        child["fleet"] = _clamp(
            child["fleet"] + rng.choice((-1, 1)),
            3,
            config.fleet_size + 2,
        )
    return child


def assert_unique_seeds(campaign_seed: int, candidates) -> Dict[int, str]:
    """Collision hardening (the cell_seed contract): two DIFFERENT
    candidates in one generated campaign must never share a seed.
    Returns the seed->identity index; raises AssertionError on any
    collision."""
    index: Dict[int, str] = {}
    for cand in candidates:
        key = candidate_key(cand)
        seed = chaos.cell_seed(
            campaign_seed,
            cand["scenario"],
            cand["transport"],
            cand["gates"],
            int(cand["fleet"]),
            cand.get("driver", "polling"),
            mutations=cand.get("mutations") or [],
        )
        other = index.get(seed)
        if other is not None and other != key:
            raise AssertionError(
                f"cell_seed collision at {seed}: {other} vs {key}"
            )
        index[seed] = key
    return index


def run_search(
    config: SearchConfig, progress=None, extra_scenarios=None
) -> dict:
    """Generation-over-generation fitness-guided search.  Elites carry
    forward (cached — never re-run, so best fitness is monotone),
    children breed by ``mutate_candidate``, immigrants keep diversity.
    Every evaluated seed is asserted unique across the run."""
    started = time.monotonic()
    table = resolve_scenarios(extra_scenarios)
    for name in config.scenarios:
        if name not in table:
            raise ValueError(f"unknown scenario {name!r}")
    pool = [
        name
        for name in (config.scenarios or tuple(table))
        if any(t in config.transports for t in table[name].transports)
    ]
    if not pool:
        raise ValueError(
            "no scenario supports the configured transports"
        )
    rng = random.Random(
        zlib.crc32(f"chaos-search:{config.seed}".encode())
    )
    evaluated: Dict[str, dict] = {}
    seed_index: Dict[int, str] = {}
    cells_run = 0
    generations: List[dict] = []
    found: List[dict] = []
    population: List[dict] = []
    seen = set()
    for _ in range(config.population):
        cand = _random_candidate(rng, config, table, pool)
        for _retry in range(8):
            if candidate_key(cand) not in seen:
                break
            cand = _random_candidate(rng, config, table, pool)
        seen.add(candidate_key(cand))
        population.append(cand)
    for gen in range(config.generations):
        new_evals = 0
        for cand in population:
            key = candidate_key(cand)
            if key in evaluated:
                continue
            if cells_run >= config.budget_cells:
                break
            seed = chaos.cell_seed(
                config.seed,
                cand["scenario"],
                cand["transport"],
                cand["gates"],
                int(cand["fleet"]),
                cand["driver"],
                mutations=cand["mutations"],
            )
            other = seed_index.get(seed)
            if other is not None and other != key:
                raise AssertionError(
                    f"cell_seed collision at {seed}: {other} vs {key}"
                )
            seed_index[seed] = key
            if progress is not None:
                progress(
                    f"gen {gen} cell {cand['scenario']}"
                    f"/{cand['transport']}/gates-{cand['gates']}"
                    f"/{cand['driver']} fleet={cand['fleet']} "
                    f"mutations={len(cand['mutations'])} ..."
                )
            row = run_mutated_cell(config.seed, cand, extra_scenarios)
            cells_run += 1
            new_evals += 1
            record = {
                "candidate": cand,
                "key": key,
                "seed": seed,
                "fitness": float(row.get("fitness_score") or 0.0),
                "violations": sorted(
                    v["invariant"] for v in row["violations"]
                ),
            }
            evaluated[key] = record
            if record["violations"]:
                found.append(
                    {
                        "candidate": {
                            **cand,
                            "mutations": [
                                dict(m) for m in cand["mutations"]
                            ],
                        },
                        "fitness": record["fitness"],
                        "generation": gen,
                        "violations": record["violations"],
                        "seed": seed,
                    }
                )
        ranked = sorted(
            (
                evaluated[candidate_key(c)]
                for c in population
                if candidate_key(c) in evaluated
            ),
            key=lambda r: (-r["fitness"], r["key"]),
        )
        best = ranked[0]["fitness"] if ranked else 0.0
        mean = (
            round(sum(r["fitness"] for r in ranked) / len(ranked), 4)
            if ranked
            else 0.0
        )
        generations.append(
            {
                "generation": gen,
                "best_fitness": best,
                "mean_fitness": mean,
                "evaluated": new_evals,
                "cells_run": cells_run,
            }
        )
        if progress is not None:
            progress(
                f"generation {gen}: best={best} mean={mean} "
                f"cells={cells_run} found={len(found)}"
            )
        if found and config.stop_on_violation:
            break
        if cells_run >= config.budget_cells:
            break
        if gen == config.generations - 1:
            break
        elites = [
            {
                **r["candidate"],
                "mutations": [
                    dict(m) for m in r["candidate"]["mutations"]
                ],
            }
            for r in ranked[: config.elite]
        ]
        next_population = list(elites)
        keys = {candidate_key(c) for c in next_population}
        parents = ranked[: max(2, len(ranked) // 2)] or ranked
        guard = 0
        while (
            len(next_population) < config.population
            and guard < config.population * 10
        ):
            guard += 1
            if parents and rng.random() >= 0.25:
                parent = parents[rng.randrange(len(parents))][
                    "candidate"
                ]
                child = mutate_candidate(rng, parent, config, table)
            else:
                child = _random_candidate(rng, config, table, pool)
            key = candidate_key(child)
            if key in keys:
                continue
            keys.add(key)
            next_population.append(child)
        population = next_population
    best_overall = max(
        (r["fitness"] for r in evaluated.values()), default=0.0
    )
    return {
        "campaign_seed": config.seed,
        "generations": generations,
        "cells_run": cells_run,
        "best_fitness": best_overall,
        "found": found,
        "wall_s": round(time.monotonic() - started, 2),
    }


# --------------------------------------------------------------------------
# The delta-debugging shrinker.
# --------------------------------------------------------------------------
def shrink(
    campaign_seed: int,
    candidate: dict,
    *,
    max_runs: int = 32,
    extra_scenarios=None,
    progress=None,
) -> dict:
    """Reduce a failing candidate to a minimal deterministic
    reproducer: greedy operator removal to fixpoint, then per-operator
    numeric shrinking, then fleet-size reduction — each trial must
    reproduce the SAME violated-invariant set (the seed-stable
    ``cell_seed``/scorecard contract makes every probe one cheap
    cell).  Bounded by ``max_runs`` cell executions."""
    runs = {"n": 0}
    best_row = {"row": None}

    def evaluate(cand):
        runs["n"] += 1
        row = run_mutated_cell(campaign_seed, cand, extra_scenarios)
        return row, sorted(v["invariant"] for v in row["violations"])

    current = dict(candidate)
    current["mutations"] = [
        dict(m) for m in (candidate.get("mutations") or [])
    ]
    current.setdefault("driver", "polling")
    row, target = evaluate(current)
    if not target:
        raise ValueError(
            "shrink: candidate does not violate any invariant"
        )
    best_row["row"] = row

    def still_fails(cand) -> bool:
        if runs["n"] >= max_runs:
            return False
        trial_row, violated = evaluate(cand)
        if violated == target:
            best_row["row"] = trial_row
            return True
        return False

    # pass 1: greedy operator removal to fixpoint
    changed = True
    while changed and runs["n"] < max_runs:
        changed = False
        for i in range(len(current["mutations"])):
            trial = dict(current)
            trial["mutations"] = [
                m
                for j, m in enumerate(current["mutations"])
                if j != i
            ]
            if still_fails(trial):
                if progress is not None:
                    progress(
                        "shrink: dropped "
                        f"{current['mutations'][i]['op']!r}"
                    )
                current = trial
                changed = True
                break
    # pass 2: numeric shrinking per surviving operator
    changed = True
    while changed and runs["n"] < max_runs:
        changed = False
        for i, m in enumerate(current["mutations"]):
            op = OPERATORS[m["op"]]
            if op.shrink is None:
                continue
            params = {k: v for k, v in m.items() if k != "op"}
            for smaller in op.shrink(params):
                trial = dict(current)
                trial["mutations"] = [
                    dict(x) for x in current["mutations"]
                ]
                trial["mutations"][i] = _with_op(op.name, smaller)
                if still_fails(trial):
                    if progress is not None:
                        progress(
                            f"shrink: {op.name} -> {smaller}"
                        )
                    current = trial
                    changed = True
                    break
            if changed:
                break
    # pass 3: fleet-size reduction (stop at the first non-failing size)
    fleet = int(current["fleet"])
    while fleet > 3 and runs["n"] < max_runs:
        trial = dict(current)
        trial["fleet"] = fleet - 1
        if not still_fails(trial):
            break
        fleet -= 1
        current = trial
        if progress is not None:
            progress(f"shrink: fleet -> {fleet}")
    seed = chaos.cell_seed(
        campaign_seed,
        current["scenario"],
        current["transport"],
        current["gates"],
        int(current["fleet"]),
        current["driver"],
        mutations=current["mutations"],
    )
    return {
        "campaign_seed": campaign_seed,
        "candidate": current,
        "seed": seed,
        "invariants": target,
        "runs": runs["n"],
        "scorecard": cell_projection(best_row["row"]),
    }


# --------------------------------------------------------------------------
# The ratchet: regression-cell persistence + replay.
# --------------------------------------------------------------------------
def load_regression_cells(path=None) -> List[dict]:
    """Cells from the ratchet file ({"cells": [...]}); missing file is
    an empty ratchet, not an error."""
    p = Path(path) if path is not None else DEFAULT_REGRESSIONS_PATH
    if not p.exists():
        return []
    data = json.loads(p.read_text())
    return [dict(c) for c in (data.get("cells") or [])]


def _regression_identity(spec: dict):
    return (
        int(spec.get("campaign_seed", 0)),
        spec["scenario"],
        spec.get("transport", "inmem"),
        spec.get("gates", "on"),
        spec.get("driver", "polling"),
        int(spec.get("fleet", 5)),
        chaos.mutation_vector_key(spec.get("mutations") or []),
    )


def ratchet_cell(reproducer: dict, path=None, note: str = "") -> dict:
    """Append a shrunk reproducer to the ratchet file as a named
    regression cell.  Idempotent: an identical cell (same campaign
    seed, scenario, axes, fleet, mutation vector) is never duplicated
    — the matrix only ever grows by NEW reproducers."""
    p = Path(path) if path is not None else DEFAULT_REGRESSIONS_PATH
    cand = reproducer["candidate"]
    invariants = list(reproducer.get("invariants") or [])
    label = invariants[0] if invariants else "violation"
    spec = {
        "cell": (
            f"regress-{label}-"
            f"{int(reproducer['seed']) & 0xFFFFFFFF:08x}"
        ),
        "scenario": cand["scenario"],
        "transport": cand.get("transport", "inmem"),
        "gates": cand.get("gates", "on"),
        "driver": cand.get("driver", "polling"),
        "fleet": int(cand.get("fleet", 5)),
        "campaign_seed": int(reproducer["campaign_seed"]),
        "mutations": [dict(m) for m in (cand.get("mutations") or [])],
        "invariants": invariants,
    }
    if note:
        spec["note"] = note
    existing = load_regression_cells(p)
    for cell in existing:
        if _regression_identity(cell) == _regression_identity(spec):
            return {"cell": cell, "added": False, "path": str(p)}
    existing.append(spec)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(
        json.dumps({"cells": existing}, indent=2, sort_keys=True) + "\n"
    )
    return {"cell": spec, "added": True, "path": str(p)}


def run_regression_cell(spec: dict, extra_scenarios=None) -> dict:
    """Replay one ratcheted cell from its serialized identity alone
    (the campaign appends these rows after the matrix)."""
    candidate = {
        "scenario": spec["scenario"],
        "transport": spec.get("transport", "inmem"),
        "gates": spec.get("gates", "on"),
        "driver": spec.get("driver", "polling"),
        "fleet": int(spec.get("fleet", 5)),
        "mutations": [dict(m) for m in (spec.get("mutations") or [])],
    }
    row = run_mutated_cell(
        int(spec.get("campaign_seed", 0)), candidate, extra_scenarios
    )
    row["cell"] = spec.get("cell") or f"regress-{spec['scenario']}"
    row["regression"] = True
    return row


# --------------------------------------------------------------------------
# The seeded-vulnerable selftest target.
#
# A PLANTED operator bug behind an arming latch: when armed and the
# scenario's ``stress`` param is positive, an external actor cordons
# the `level` tail nodes of the fleet mid-wave (cycle 3) and releases
# them at cycle 6.  At low stress the cell merely runs its budget
# headroom to the floor (a strong fitness signal, no violation); past
# the trip level the combined operator + external unavailability
# overshoots maxUnavailable at a settled point — exactly the graded
# cliff a fitness-guided searcher must climb.  The scenario lives in
# EXTRA_SCENARIOS, never in chaos.SCENARIOS: the default 42-cell
# matrix is unchanged.
# --------------------------------------------------------------------------
_SEEDED_BUG = {"armed": False}


def arm_seeded_bug(flag: bool = True) -> bool:
    """Arm (or disarm — 'fix') the planted invariant bug."""
    _SEEDED_BUG["armed"] = bool(flag)
    return _SEEDED_BUG["armed"]


def _vuln_tick(cell, cycle: int) -> None:
    level = int((cell.scenario.params or {}).get("stress", 0) or 0)
    # blast radius scales as level-1: the operator already runs budget
    # headroom to the floor mid-wave, so the FIRST cordoned node
    # overshoots — level 1 must stay sub-critical for the gradient the
    # searcher climbs (trip point is level 2)
    blast = max(0, level - 1)
    if not _SEEDED_BUG["armed"] or blast <= 0:
        return
    names = sorted(cell.fleet.managed_nodes)
    targets = names[-min(blast, len(names)):]
    if cycle == 3:
        for name in targets:
            try:
                cell.store.patch(
                    "Node", name, {"spec": {"unschedulable": True}}
                )
            except ApiError:
                pass
        cell.notes["vuln_cordoned"] = len(targets)
    elif cycle == 6:
        for name in targets:
            try:
                cell.store.patch(
                    "Node", name, {"spec": {"unschedulable": False}}
                )
            except ApiError:
                pass


def _vuln_evidence(cell) -> str:
    level = int((cell.scenario.params or {}).get("stress", 0) or 0)
    if (
        _SEEDED_BUG["armed"]
        and level > 1
        and not cell.notes.get("vuln_cordoned")
    ):
        return "seeded bug armed but the cordon never fired"
    return ""


EXTRA_SCENARIOS: Dict[str, chaos.Scenario] = {
    "seeded-vulnerable": chaos.Scenario(
        name="seeded-vulnerable",
        description="searcher selftest target: a planted bug "
        "externally cordons the fleet tail mid-wave once the "
        "scenario's stress level passes the trip point — budget "
        "headroom shrinks gradually below it, overshoots above it",
        transports=("inmem",),
        gates=("on",),
        drivers=("polling",),
        tick=_vuln_tick,
        evidence=_vuln_evidence,
        params={"stress": 0},
        max_cycles=60,
    ),
}


# --------------------------------------------------------------------------
# Selftest (the `make verify-chaos-search` gate).
# --------------------------------------------------------------------------
#: pinned so the selftest is byte-reproducible: gen 0 samples stress
#: levels below the trip point (fitness < 1.0), breeding climbs past it
#: in generation 1 after 5 evaluated cells
SELFTEST_SEED = 1


def selftest(progress=None) -> str:
    """The self-proving end-to-end demo: plant a known invariant bug,
    watch fitness climb generation over generation until the searcher
    finds the violation, shrink it to a minimal reproducer, replay the
    reproducer byte-identically from its seed alone, ratchet it into
    the matrix (42 -> >=43 cells), then 'fix' the bug and prove the
    ratcheted cell replays green."""
    tmp = tempfile.mkdtemp(prefix="chaos-search-selftest-")
    ratchet_path = os.path.join(tmp, "regressions.json")
    armed_before = _SEEDED_BUG["armed"]
    try:
        arm_seeded_bug(True)
        config = SearchConfig(
            seed=SELFTEST_SEED,
            generations=4,
            population=5,
            elite=2,
            fleet_size=6,
            budget_cells=36,
            scenarios=("seeded-vulnerable",),
            transports=("inmem",),
            operators=("stress",),
            mutations_max=1,
        )
        result = run_search(config, progress=progress)
        gens = result["generations"]
        if not result["found"]:
            raise AssertionError(
                "selftest: the searcher never found the seeded "
                f"violation (best {result['best_fitness']})"
            )
        if gens[0]["best_fitness"] >= 1.0:
            raise AssertionError(
                "selftest: generation 0 already violated — no climb "
                "to demonstrate"
            )
        if result["best_fitness"] <= gens[0]["best_fitness"]:
            raise AssertionError("selftest: fitness never climbed")
        finding = result["found"][0]
        reproducer = shrink(
            config.seed, finding["candidate"], progress=progress
        )
        mutations = reproducer["candidate"]["mutations"]
        if len(mutations) != 1 or mutations[0]["op"] != "stress":
            raise AssertionError(
                "selftest: shrinker did not reduce to the stress op: "
                f"{mutations}"
            )
        replays = [
            json.dumps(
                cell_projection(
                    run_mutated_cell(
                        config.seed, reproducer["candidate"]
                    )
                ),
                sort_keys=True,
            )
            for _ in range(2)
        ]
        want = json.dumps(reproducer["scorecard"], sort_keys=True)
        if replays[0] != replays[1] or replays[0] != want:
            raise AssertionError(
                "selftest: reproducer replay was not byte-identical"
            )
        ratcheted = ratchet_cell(
            reproducer,
            path=ratchet_path,
            note="chaos search selftest",
        )
        if not ratcheted["added"]:
            raise AssertionError(
                "selftest: ratchet did not add the reproducer"
            )
        matrix = len(chaos.Campaign().cells()) + len(
            load_regression_cells(ratchet_path)
        )
        if matrix < 43:
            raise AssertionError(
                f"selftest: matrix only reached {matrix} cells"
            )
        if ratchet_cell(reproducer, path=ratchet_path)["added"]:
            raise AssertionError(
                "selftest: ratchet duplicated an identical cell"
            )
        # the "fix": disarm the planted bug — the ratcheted cell must
        # now replay green from its serialized identity alone
        arm_seeded_bug(False)
        green = run_regression_cell(load_regression_cells(ratchet_path)[0])
        if not (green["passed"] and green["converged"]):
            raise AssertionError(
                "selftest: ratcheted cell stayed red after the fix: "
                f"{[v['invariant'] for v in green['violations']]}"
            )
        level = mutations[0]["level"]
        return (
            "chaos search selftest: seeded bug found at fitness "
            f"{finding['fitness']} in generation "
            f"{finding['generation']} (gen-0 best "
            f"{gens[0]['best_fitness']}), shrunk to stress level "
            f"{level} on a fleet of "
            f"{reproducer['candidate']['fleet']} in "
            f"{reproducer['runs']} runs, ratcheted to a "
            f"{matrix}-cell matrix, and replayed green once fixed"
        )
    finally:
        _SEEDED_BUG["armed"] = armed_before
        shutil.rmtree(tmp, ignore_errors=True)

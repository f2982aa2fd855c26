"""Coverage-guided chaos search (upgrade/chaossearch.py): the graded
fitness signals the searcher climbs, seed-collision hardening over
mutation vectors, the operator catalog's serializability, scenario
derivation, search/shrink determinism (against a fast fake cell
runner), the ratchet's idempotent persistence, and the seeded
selftest target's graded cliff.

The end-to-end loop — mutate, score, shrink, ratchet, replay — runs
in ``make verify-chaos-search`` (``chaos search --selftest``); this
suite keeps tier-1 fast by driving the pieces directly and only
running single inmem cells where a real rollout is the point.


Every class of ``tests/test_chaossearch.py``, as cases of the same names, on the
port (``k8s_operator_libs_tpu_torch``) in its GPU-fleet vocabulary."""

import json
import random
import zlib

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade import chaos, chaossearch
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


# ---------------------------------------------------------------- helpers
def _policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def _store():
    store = InMemoryCluster()
    store.create({"kind": "Node", "metadata": {"name": "a"}})
    return store


def _tape(**fields):
    tape = chaos.AuditTape(_store(), _policy())
    for name, value in fields.items():
        setattr(tape, name, value)
    return tape


def _signals(**kwargs):
    kwargs.setdefault("decisions", [])
    return chaos.fitness_signals(policy=_policy(), **kwargs)


# ------------------------------------------------- fitness signals (S3)
class TestFitnessSignals:
    """Each signal must score a tape/stream that APPROACHES its
    invariant strictly higher than a healthy one, by name — the
    gradient the searcher climbs."""

    def test_vocabulary_is_closed_and_normalized(self):
        healthy = _signals(tape=_tape())
        assert set(healthy) == set(chaos.FITNESS_SIGNALS)
        assert all(0.0 <= v <= 1.0 for v in healthy.values())

    def test_budget_headroom_rises_as_slack_shrinks(self):
        relaxed = _signals(tape=_tape(min_unavail_headroom=3))
        tight = _signals(tape=_tape(min_unavail_headroom=1))
        at_cliff = _signals(tape=_tape(min_unavail_headroom=0))
        assert (
            at_cliff["budget-headroom"]
            > tight["budget-headroom"]
            > relaxed["budget-headroom"]
            > 0.0
        )
        assert at_cliff["budget-headroom"] == 1.0
        # the parallel-budget headroom feeds the same signal
        parallel = _signals(tape=_tape(min_parallel_headroom=0))
        assert parallel["budget-headroom"] == 1.0

    def test_breaker_margin_tracks_failure_ratio_and_saturates(self):
        remediation = RemediationSpec(failure_threshold=0.5)
        policy = _policy(remediation=remediation)
        admitted = [
            {"type": events_mod.EVENT_NODE_ADMITTED, "target": n}
            for n in ("a", "b", "c", "d")
        ]
        failed_one = admitted + [
            {"type": events_mod.EVENT_NODE_UPGRADE_FAILED, "target": "a"}
        ]
        healthy = chaos.fitness_signals(decisions=admitted, policy=policy)
        near = chaos.fitness_signals(decisions=failed_one, policy=policy)
        # 1 failed / 4 attempted against a 0.5 threshold: halfway there
        assert healthy["breaker-margin"] == 0.0
        assert near["breaker-margin"] == pytest.approx(0.5)
        tripped = chaos.fitness_signals(
            decisions=[{"type": events_mod.EVENT_BREAKER_TRIPPED}],
            policy=policy,
        )
        assert tripped["breaker-margin"] == 1.0

    def test_audit_near_gap_width_and_actual_gap(self):
        healthy = _signals(tape=_tape())
        narrow = _signals(
            tape=_tape(min_journal_slack=1, journal_cap_seen=64)
        )
        wide = _signals(
            tape=_tape(min_journal_slack=32, journal_cap_seen=64)
        )
        gapped = _signals(tape=_tape(gaps=1))
        assert healthy["audit-near-gap"] == 0.0
        assert gapped["audit-near-gap"] == 1.0
        assert (
            gapped["audit-near-gap"]
            > narrow["audit-near-gap"]
            > wide["audit-near-gap"]
            > healthy["audit-near-gap"]
        )

    def test_decision_anomaly_density_saturates(self):
        anomalies = [
            {"type": events_mod.EVENT_NODE_UPGRADE_FAILED, "target": "a"},
            {"type": events_mod.EVENT_BREAKER_TRIPPED},
        ]
        calm = chaos.fitness_signals(
            decisions=[{"type": events_mod.EVENT_NODE_ADMITTED}],
            policy=_policy(),
        )
        noisy = chaos.fitness_signals(
            decisions=anomalies, policy=_policy()
        )
        storm = chaos.fitness_signals(
            decisions=anomalies * 20, policy=_policy()
        )
        assert calm["decision-anomalies"] == 0.0
        assert 0.0 < noisy["decision-anomalies"] < 1.0
        assert noisy["decision-anomalies"] < storm["decision-anomalies"]
        assert storm["decision-anomalies"] < 1.0  # saturating, never 1

    def test_stream_parity_slack_counts_unlanded_decisions(self):
        live = [
            {"type": "NodeAdmitted", "reason": "r", "target": "a"},
            {"type": "NodeAdmitted", "reason": "r", "target": "b"},
        ]
        landed = chaos.fitness_signals(
            decisions=live, persisted_decisions=list(live),
            policy=_policy(),
        )
        lagging = chaos.fitness_signals(
            decisions=live, persisted_decisions=[], policy=_policy()
        )
        assert landed["stream-parity-slack"] == 0.0
        assert lagging["stream-parity-slack"] > 0.0

    def test_fitness_score_violations_dominate_every_signal_mean(self):
        saturated = {name: 1.0 for name in chaos.FITNESS_SIGNALS}
        assert chaos.fitness_score(saturated) == 0.9999  # capped < 1
        assert chaos.fitness_score({}, violations=None) == 0.0
        one = chaos.fitness_score({}, violations=[object()])
        two = chaos.fitness_score(saturated, violations=[object()] * 2)
        assert one == 2.0 and two == 3.0
        assert one > chaos.fitness_score(saturated)


# ------------------------------------------- seed-collision hardening (S2)
class TestSeedUniqueness:
    def test_empty_vector_keys_exactly_as_historical_seed(self):
        bare = chaos.cell_seed(7, "policy-edits", "inmem", "on", 5)
        assert bare == chaos.cell_seed(
            7, "policy-edits", "inmem", "on", 5, mutations=[]
        )
        assert bare == chaos.cell_seed(
            7, "policy-edits", "inmem", "on", 5, mutations=None
        )

    def test_mutation_vector_folds_into_the_seed(self):
        base = chaos.cell_seed(7, "policy-edits", "inmem", "on", 5)
        mutated = chaos.cell_seed(
            7, "policy-edits", "inmem", "on", 5,
            mutations=[{"op": "stress", "level": 2}],
        )
        other = chaos.cell_seed(
            7, "policy-edits", "inmem", "on", 5,
            mutations=[{"op": "stress", "level": 3}],
        )
        assert len({base, mutated, other}) == 3

    def test_vector_key_is_formatting_insensitive(self):
        a = chaos.mutation_vector_key([{"op": "latency", "ms": 2}])
        b = chaos.mutation_vector_key([{"ms": 2, "op": "latency"}])
        assert a == b

    def test_assert_unique_seeds_over_mutated_variants(self):
        candidates = [
            {
                "scenario": "seeded-vulnerable",
                "transport": "inmem",
                "gates": "on",
                "driver": "polling",
                "fleet": fleet,
                "mutations": [{"op": "stress", "level": level}],
            }
            for fleet in (4, 5, 6)
            for level in range(6)
        ]
        index = chaossearch.assert_unique_seeds(0, candidates)
        assert len(index) == len(candidates)

    def test_collision_raises(self, monkeypatch):
        monkeypatch.setattr(chaos, "cell_seed", lambda *a, **k: 42)
        candidates = [
            {"scenario": "s", "transport": "inmem", "gates": "on",
             "driver": "polling", "fleet": 5, "mutations": []},
            {"scenario": "t", "transport": "inmem", "gates": "on",
             "driver": "polling", "fleet": 5, "mutations": []},
        ]
        with pytest.raises(AssertionError, match="cell_seed collision"):
            chaossearch.assert_unique_seeds(0, candidates)


# -------------------------------------------------- the operator catalog
class TestOperatorCatalog:
    def test_samples_perturbs_and_shrinks_are_plain_json(self):
        rng = random.Random(3)
        for op in chaossearch.OPERATORS.values():
            for _ in range(16):
                params = op.sample(rng)
                json.loads(json.dumps(params))  # JSON-able
                if op.perturb is not None:
                    perturbed = op.perturb(rng, dict(params))
                    json.loads(json.dumps(perturbed))
                if op.shrink is not None:
                    for smaller in op.shrink(dict(params)):
                        json.loads(json.dumps(smaller))
                        assert smaller != params

    def test_shrink_proposals_reach_a_fixpoint(self):
        """Repeatedly taking the first shrink proposal terminates —
        the shrinker's pass 2 relies on it."""
        rng = random.Random(5)
        for op in chaossearch.OPERATORS.values():
            if op.shrink is None:
                continue
            params = op.sample(rng)
            for _ in range(64):
                proposals = op.shrink(dict(params))
                if not proposals:
                    break
                params = proposals[0]
            else:
                pytest.fail(f"{op.name} shrink never reached a fixpoint")

    def test_applicability_filters_by_transport_and_scenario(self):
        brownout = chaos.SCENARIOS["apiserver-brownout"]
        http = {"transport": "http"}
        inmem = {"transport": "inmem"}
        assert chaossearch.OPERATORS["latency"].applies(brownout, http)
        assert not chaossearch.OPERATORS["latency"].applies(
            brownout, inmem
        )
        vuln = chaossearch.EXTRA_SCENARIOS["seeded-vulnerable"]
        assert chaossearch.OPERATORS["stress"].applies(vuln, inmem)
        assert not chaossearch.OPERATORS["stress"].applies(
            brownout, inmem
        )
        # held-frames needs the held client mode on top of http
        assert not chaossearch.OPERATORS["held-frames"].applies(
            brownout, http
        )

    def test_every_operator_applies_somewhere(self):
        table = chaossearch.resolve_scenarios()
        for name, op in chaossearch.OPERATORS.items():
            hits = [
                s.name
                for s in table.values()
                for transport in s.transports
                if op.applies(s, {"transport": transport})
            ]
            assert hits, f"operator {name} applies to no catalog cell"


# ------------------------------------------------- scenario derivation
class TestDeriveScenario:
    def test_empty_vector_returns_the_base_unchanged(self):
        base = chaos.SCENARIOS["apiserver-brownout"]
        assert chaossearch.derive_scenario(base, []) is base

    def test_tick_shift_delays_only_the_base_timeline(self):
        base_cycles, op_cycles = [], []
        base = chaos.Scenario(
            name="probe",
            description="",
            tick=lambda cell, cycle: base_cycles.append(cycle),
        )
        derived = chaossearch.derive_scenario(
            base,
            [
                {"op": "tick-shift", "delta": 2},
                {"op": "stress", "level": 1},
            ],
        )
        # drive the derived tick directly: cycles 0..4, shift 2 — the
        # base timeline starts late, operator params land immediately
        for cycle in range(5):
            derived.tick(None, cycle)
        assert base_cycles == [0, 1, 2]  # cycle-2 .. cycle-4, shifted
        assert derived.params == {"stress": 1}
        assert op_cycles == []  # param ops install no tick hooks

    def test_param_rewrites_land_in_scenario_params(self):
        base = chaossearch.EXTRA_SCENARIOS["seeded-vulnerable"]
        derived = chaossearch.derive_scenario(
            base, [{"op": "stress", "level": 3}]
        )
        assert derived.params == {"stress": 3}
        assert base.params == {"stress": 0}  # base untouched
        assert derived.evidence is base.evidence

    def test_unknown_op_is_rejected_before_running(self):
        with pytest.raises(ValueError, match="unknown mutation op"):
            chaossearch.run_mutated_cell(
                0,
                {
                    "scenario": "apiserver-brownout",
                    "transport": "inmem",
                    "gates": "on",
                    "mutations": [{"op": "no-such-op"}],
                },
            )

    def test_inapplicable_op_is_rejected_before_running(self):
        with pytest.raises(ValueError, match="does not apply"):
            chaossearch.run_mutated_cell(
                0,
                {
                    "scenario": "apiserver-brownout",
                    "transport": "inmem",
                    "gates": "on",
                    "mutations": [{"op": "latency", "ms": 2}],
                },
            )


# ---------------------------------------------- search over a fake runner
def _fake_runner(violates):
    """A deterministic stand-in for run_mutated_cell: fitness derives
    from the candidate's canonical key, violation from a predicate —
    the searcher's control flow under test, not the rollout."""

    def fake(campaign_seed, candidate, extra_scenarios=None):
        key = chaossearch.candidate_key(candidate)
        violations = (
            [{"invariant": "budget-never-overshot", "detail": "fake"}]
            if violates(candidate)
            else []
        )
        signals = {"budget-headroom": (hash_stable(key) % 997) / 1000.0}
        return {
            "scenario": candidate["scenario"],
            "transport": candidate["transport"],
            "gates": candidate["gates"],
            "driver": candidate.get("driver", "polling"),
            "fleet": candidate["fleet"],
            "seed": chaos.cell_seed(
                campaign_seed,
                candidate["scenario"],
                candidate["transport"],
                candidate["gates"],
                int(candidate["fleet"]),
                candidate.get("driver", "polling"),
                mutations=candidate.get("mutations") or [],
            ),
            "passed": not violations,
            "converged": True,
            "violations": violations,
            "fitness_score": chaos.fitness_score(signals, violations),
            "mutations": [
                dict(m) for m in (candidate.get("mutations") or [])
            ],
        }

    return fake


def hash_stable(text: str) -> int:
    return zlib.crc32(text.encode())


def _strip_wall(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "wall_s"}


class TestRunSearch:
    CONFIG = dict(
        seed=11,
        generations=3,
        population=5,
        elite=2,
        fleet_size=5,
        budget_cells=20,
        scenarios=("seeded-vulnerable",),
        operators=("stress",),
        mutations_max=1,
    )

    def test_same_config_replays_byte_identical(self, monkeypatch):
        monkeypatch.setattr(
            chaossearch, "run_mutated_cell",
            _fake_runner(lambda c: False),
        )
        config = chaossearch.SearchConfig(**self.CONFIG)
        first = chaossearch.run_search(config)
        second = chaossearch.run_search(
            chaossearch.SearchConfig(**self.CONFIG)
        )
        assert _strip_wall(first) == _strip_wall(second)
        assert first["found"] == []
        assert first["cells_run"] <= config.budget_cells
        assert len(first["generations"]) == config.generations

    def test_stop_on_violation_and_found_record_shape(self, monkeypatch):
        monkeypatch.setattr(
            chaossearch, "run_mutated_cell",
            _fake_runner(
                lambda c: any(
                    m.get("level", 0) >= 1 for m in c["mutations"]
                )
            ),
        )
        config = chaossearch.SearchConfig(**self.CONFIG)
        result = chaossearch.run_search(config)
        assert result["found"]
        finding = result["found"][0]
        assert finding["violations"] == ["budget-never-overshot"]
        assert finding["fitness"] == 2.0
        assert finding["seed"] == chaos.cell_seed(
            config.seed,
            finding["candidate"]["scenario"],
            finding["candidate"]["transport"],
            finding["candidate"]["gates"],
            int(finding["candidate"]["fleet"]),
            finding["candidate"]["driver"],
            mutations=finding["candidate"]["mutations"],
        )
        # stop_on_violation: the search ends with the finding's round
        assert (
            len(result["generations"])
            == finding["generation"] + 1
        )
        assert result["best_fitness"] == 2.0

    def test_budget_caps_new_evaluations(self, monkeypatch):
        monkeypatch.setattr(
            chaossearch, "run_mutated_cell",
            _fake_runner(lambda c: False),
        )
        config = chaossearch.SearchConfig(
            **{**self.CONFIG, "budget_cells": 3}
        )
        result = chaossearch.run_search(config)
        assert result["cells_run"] == 3

    def test_unknown_scenario_rejected(self):
        with pytest.raises(ValueError, match="unknown scenario"):
            chaossearch.run_search(
                chaossearch.SearchConfig(scenarios=("no-such",))
            )

    def test_mutate_candidate_respects_transport_applicability(self):
        """A transport flip drops operators that no longer apply —
        vectors stay runnable."""
        table = chaossearch.resolve_scenarios()
        config = chaossearch.SearchConfig(
            transports=("inmem", "http"), mutations_max=2
        )
        rng = random.Random(0)
        candidate = {
            "scenario": "apiserver-brownout",
            "transport": "http",
            "gates": "on",
            "driver": "polling",
            "fleet": 5,
            "mutations": [{"op": "latency", "ms": 2}],
        }
        for _ in range(200):
            child = chaossearch.mutate_candidate(
                rng, candidate, config, table
            )
            scenario = table[child["scenario"]]
            for m in child["mutations"]:
                assert chaossearch.OPERATORS[m["op"]].applies(
                    scenario, child
                )


# -------------------------------------------------------- the shrinker
class TestShrink:
    def test_minimizes_vector_params_and_fleet(self, monkeypatch):
        monkeypatch.setattr(
            chaossearch, "run_mutated_cell",
            _fake_runner(
                lambda c: any(
                    m["op"] == "latency" and m.get("ms", 0) >= 2
                    for m in c["mutations"]
                )
            ),
        )
        candidate = {
            "scenario": "apiserver-brownout",
            "transport": "http",
            "gates": "on",
            "driver": "polling",
            "fleet": 6,
            "mutations": [
                {"op": "latency", "ms": 4},
                {"op": "tick-shift", "delta": 2},
            ],
        }
        reproducer = chaossearch.shrink(0, candidate)
        assert reproducer["candidate"]["mutations"] == [
            {"op": "latency", "ms": 2}
        ]
        assert reproducer["candidate"]["fleet"] == 3
        assert reproducer["invariants"] == ["budget-never-overshot"]
        # the scorecard is the minimal cell's projection, seed-stable
        assert reproducer["scorecard"]["seed"] == reproducer["seed"]
        assert reproducer["scorecard"]["violations"] == [
            "budget-never-overshot"
        ]
        assert reproducer["runs"] <= 32

    def test_non_failing_candidate_is_rejected(self, monkeypatch):
        monkeypatch.setattr(
            chaossearch, "run_mutated_cell",
            _fake_runner(lambda c: False),
        )
        with pytest.raises(ValueError, match="does not violate"):
            chaossearch.shrink(
                0,
                {
                    "scenario": "apiserver-brownout",
                    "transport": "inmem",
                    "gates": "on",
                    "fleet": 5,
                    "mutations": [],
                },
            )

    def test_max_runs_bounds_the_probe_count(self, monkeypatch):
        calls = {"n": 0}
        base = _fake_runner(lambda c: True)

        def counting(campaign_seed, candidate, extra_scenarios=None):
            calls["n"] += 1
            return base(campaign_seed, candidate, extra_scenarios)

        monkeypatch.setattr(chaossearch, "run_mutated_cell", counting)
        reproducer = chaossearch.shrink(
            0,
            {
                "scenario": "apiserver-brownout",
                "transport": "http",
                "gates": "on",
                "fleet": 30,
                "mutations": [
                    {"op": "latency", "ms": 10},
                    {"op": "chaos-drop", "ratio": 0.3},
                    {"op": "tick-shift", "delta": 8},
                ],
            },
            max_runs=8,
        )
        assert calls["n"] <= 9  # baseline + at most max_runs probes
        assert reproducer["runs"] <= 9


# ---------------------------------------------------------- the ratchet
class TestRatchet:
    REPRODUCER = {
        "campaign_seed": 0,
        "seed": 0xDEADBEEF,
        "invariants": ["budget-never-overshot"],
        "candidate": {
            "scenario": "seeded-vulnerable",
            "transport": "inmem",
            "gates": "on",
            "driver": "polling",
            "fleet": 5,
            "mutations": [{"op": "stress", "level": 2}],
        },
    }

    def test_missing_file_is_an_empty_ratchet(self, tmp_path):
        assert chaossearch.load_regression_cells(
            tmp_path / "nope.json"
        ) == []

    def test_append_then_dedupe(self, tmp_path):
        path = tmp_path / "regress.json"
        first = chaossearch.ratchet_cell(
            self.REPRODUCER, path=path, note="planted"
        )
        assert first["added"]
        assert first["cell"]["cell"] == (
            "regress-budget-never-overshot-deadbeef"
        )
        cells = chaossearch.load_regression_cells(path)
        assert len(cells) == 1
        assert cells[0]["note"] == "planted"
        assert cells[0]["mutations"] == [{"op": "stress", "level": 2}]
        # identical identity: never duplicated, matrix only grows
        again = chaossearch.ratchet_cell(self.REPRODUCER, path=path)
        assert not again["added"]
        assert len(chaossearch.load_regression_cells(path)) == 1
        # a DIFFERENT vector is a new cell
        other = json.loads(json.dumps(self.REPRODUCER))
        other["candidate"]["mutations"][0]["level"] = 3
        assert chaossearch.ratchet_cell(other, path=path)["added"]
        assert len(chaossearch.load_regression_cells(path)) == 2

    def test_ratchet_file_is_deterministic_bytes(self, tmp_path):
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        chaossearch.ratchet_cell(self.REPRODUCER, path=a)
        chaossearch.ratchet_cell(self.REPRODUCER, path=b)
        assert a.read_bytes() == b.read_bytes()

    def test_shipped_regressions_parse_and_extend_the_matrix(self):
        cells = chaossearch.load_regression_cells()
        assert cells, "the shipped ratchet file must not be empty"
        for spec in cells:
            assert spec["scenario"] in chaossearch.resolve_scenarios()
            for m in spec.get("mutations") or []:
                assert m["op"] in chaossearch.OPERATORS
        campaign = chaos.Campaign()
        assert len(campaign.cells()) + len(cells) >= 43


# ------------------------------------------ the seeded selftest target
class TestSeededVulnerable:
    @pytest.fixture(autouse=True)
    def _disarm_after(self):
        was = chaossearch._SEEDED_BUG["armed"]
        yield
        chaossearch._SEEDED_BUG["armed"] = was

    def _run(self, level, fleet=6):
        return chaossearch.run_mutated_cell(
            0,
            {
                "scenario": "seeded-vulnerable",
                "transport": "inmem",
                "gates": "on",
                "driver": "polling",
                "fleet": fleet,
                "mutations": (
                    [{"op": "stress", "level": level}] if level else []
                ),
            },
        )

    def test_graded_cliff_sub_critical_then_violation(self):
        chaossearch.arm_seeded_bug(True)
        calm = self._run(0)
        assert calm["passed"] and calm["fitness_score"] < 1.0
        tripped = self._run(2)
        assert not tripped["passed"]
        assert tripped["fitness_score"] > 1.0
        violated = {v["invariant"] for v in tripped["violations"]}
        assert "budget-never-overshot" in violated

    def test_disarmed_bug_is_fixed_code(self):
        chaossearch.arm_seeded_bug(False)
        row = self._run(2)
        assert row["passed"] and row["converged"]

    def test_scenario_stays_out_of_the_default_catalog(self):
        assert "seeded-vulnerable" not in chaos.SCENARIOS
        assert "seeded-vulnerable" in chaossearch.resolve_scenarios()


# ---------------------------------------------- regression-cell replay
class TestRegressionReplay:
    def test_replay_from_serialized_identity_alone(self):
        """A ratcheted reproducer of the seeded bug replays red while
        armed and green once disarmed — from the spec dict alone."""
        spec = {
            "cell": "regress-budget-never-overshot-test",
            "scenario": "seeded-vulnerable",
            "transport": "inmem",
            "gates": "on",
            "driver": "polling",
            "fleet": 5,
            "campaign_seed": 0,
            "mutations": [{"op": "stress", "level": 2}],
            "invariants": ["budget-never-overshot"],
        }
        was = chaossearch._SEEDED_BUG["armed"]
        try:
            chaossearch.arm_seeded_bug(True)
            red = chaossearch.run_regression_cell(spec)
            assert not red["passed"]
            assert red["regression"] is True
            assert red["cell"] == spec["cell"]
            chaossearch.arm_seeded_bug(False)
            green = chaossearch.run_regression_cell(spec)
            assert green["passed"]
            # same identity, same seed, armed or not
            assert red["seed"] == green["seed"]
        finally:
            chaossearch._SEEDED_BUG["armed"] = was

    def test_scorecard_projection_carries_the_vector(self):
        was = chaossearch._SEEDED_BUG["armed"]
        try:
            chaossearch.arm_seeded_bug(False)
            row = chaossearch.run_mutated_cell(
                0,
                {
                    "scenario": "seeded-vulnerable",
                    "transport": "inmem",
                    "gates": "on",
                    "driver": "polling",
                    "fleet": 4,
                    "mutations": [{"op": "stress", "level": 1}],
                },
            )
        finally:
            chaossearch._SEEDED_BUG["armed"] = was
        projection = chaossearch.cell_projection(row)
        assert projection["mutations"] == [{"op": "stress", "level": 1}]
        assert projection["seed"] == row["seed"]
        assert isinstance(projection["fitness_score"], float)


# ------------------------------------------------- against the JAX package


def _recorded_search(module, monkeypatch, **config):
    """*module*'s ``run_search`` on real cells, with each evaluated
    candidate and its row's ``cell_projection`` recorded in order."""
    seen = []
    run = module.run_mutated_cell

    def recording(campaign_seed, candidate, extra_scenarios=None):
        row = run(campaign_seed, candidate, extra_scenarios)
        seen.append({"candidate": candidate, "cell": module.cell_projection(row)})
        return row

    monkeypatch.setattr(module, "run_mutated_cell", recording)
    result = module.run_search(module.SearchConfig(**config))
    return {k: v for k, v in result.items() if k != "wall_s"}, seen


class TestAgainstJax:
    """The port's search against the JAX package's from one seed: the
    same candidates in the same order, the same projections of their
    cells and the same result, after ``to_port_vocab``."""

    CONFIG = dict(
        seed=5, generations=2, population=3, elite=1, fleet_size=4, budget_cells=5,
        scenarios=("policy-edits", "operator-crash"), mutations_max=2,
    )

    def test_a_small_search_finds_the_jax_candidates(self, monkeypatch):
        from k8s_operator_libs_tpu.upgrade import chaossearch as jchaossearch

        from test_torch_vocab import to_port_vocab

        jax_result, jax_seen = _recorded_search(jchaossearch, monkeypatch, **self.CONFIG)
        result, seen = _recorded_search(chaossearch, monkeypatch, **self.CONFIG)
        assert len(seen) == result["cells_run"] == self.CONFIG["budget_cells"]
        assert seen == to_port_vocab(jax_seen)
        assert result == to_port_vocab(jax_result)
        assert any(s["candidate"]["mutations"] for s in seen)

    def test_both_selftests_pass(self):
        from k8s_operator_libs_tpu.upgrade import chaossearch as jchaossearch

        for module in (jchaossearch, chaossearch):
            assert module.selftest()

"""Chaos campaign engine (upgrade/chaos.py): the composable fault
surface, the rollout-invariant checker's ability to both pass healthy
cells and FAIL tampered ones, the declarative campaign format, and
seed-deterministic scorecards.

The full default campaign (12 scenarios × transport/gates axes) runs in
``make chaos`` / the bench scorecard; this suite keeps tier-1 fast by
driving single cells and the checker directly.


Every class of ``tests/test_chaos.py``, as cases of the same names, on the
port (``k8s_operator_libs_tpu_torch``) in its GPU-fleet vocabulary."""

import json

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster import (
    FAULT_KINDS,
    ApiServerFacade,
    FaultSpec,
    InMemoryCluster,
    KubeApiClient,
    KubeConfig,
)
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade import chaos, consts, util
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


# ------------------------------------------------------------ fault surface
class TestComposableFaults:
    def test_with_faults_partial_updates_compose(self):
        """Chained with_faults calls only change the knobs they pass —
        a campaign cell layers drop-ratio chaos under a latency fault
        under a targeted partition hook without re-stating any of them."""
        store = InMemoryCluster()
        facade = ApiServerFacade(store)
        hook = lambda *a: None  # noqa: E731
        part = lambda *a: False  # noqa: E731
        facade.with_chaos(0.25, seed=7)
        facade.with_faults(request_hook=hook)
        facade.with_faults(request_latency_seconds=0.5, latency_seed=3)
        facade.with_faults(partition_hook=part, held_stream_max_frames=9)
        cls = facade._handler_cls
        assert cls.chaos_drop_ratio == 0.25
        assert cls.request_hook is hook
        assert cls.request_latency_seconds == 0.5
        assert cls.latency_rng is not None
        assert cls.partition_hook is part
        assert cls.held_stream_max_frames == 9
        # one explicit reset clears only its own knob...
        facade.with_faults(request_hook=None)
        assert cls.request_hook is None
        assert cls.request_latency_seconds == 0.5
        # ...and clear_faults resets everything, chaos included
        facade.clear_faults()
        assert cls.request_latency_seconds == 0.0
        assert cls.partition_hook is None
        assert cls.held_stream_max_frames == 0
        assert cls.chaos_drop_ratio == 0.0

    def test_latency_partition_and_body_hooks_fire_over_http(self):
        """The three new fault kinds are observable: latency stalls
        count, a targeted partition resets the selected kind's
        connections, and the body hook rewrites write bodies — each
        tallied in fault_counters."""
        store = InMemoryCluster()
        drops = {"left": 1}

        def partition(method, info, namespace, name, query) -> bool:
            if drops["left"] > 0 and info.kind == "Pod":
                drops["left"] -= 1
                return True
            return False

        def skew(method, path, body):
            if body.get("kind") != "Event":
                return None
            mutated = dict(body)
            mutated["message"] = "skewed"
            return mutated

        facade = (
            ApiServerFacade(store)
            .with_faults(
                request_latency_seconds=0.001,
                latency_seed=1,
                partition_hook=partition,
                body_hook=skew,
            )
            .start()
        )
        try:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=5.0)
            store.create({"kind": "Node", "metadata": {"name": "n0"}})
            assert client.get("Node", "n0")["metadata"]["name"] == "n0"
            # the partitioned kind's first request is reset on the wire;
            # the client may absorb it via its idle-connection replay or
            # surface it — either way the drop is counted and traffic
            # flows again afterwards
            try:
                client.list("Pod", namespace="default")
            except OSError:
                pass
            assert client.list("Pod", namespace="default") == []
            client.create(
                {
                    "kind": "Event",
                    "metadata": {"name": "e1", "namespace": "default"},
                    "reason": "Probe",
                    "message": "original",
                }
            )
        finally:
            facade.stop()
        assert facade.fault_counters["delayed_requests"] >= 2
        assert facade.fault_counters["partition_drops"] == 1
        assert facade.fault_counters["body_mutations"] >= 1
        assert store.get("Event", "e1", "default")["message"] == "skewed"

    def test_faultspec_roundtrip_and_per_kind_clear(self):
        """FaultSpec is the serializable slice of the fault stack: it
        round-trips through plain dicts, rejects unknown fields, and
        ``cleared(kind)`` resets exactly one kind's knobs (the searcher
        persists these in mutation vectors)."""
        spec = FaultSpec(
            chaos_drop_ratio=0.25,
            chaos_seed=7,
            request_latency_seconds=0.5,
            latency_seed=3,
            held_stream_max_frames=9,
        )
        assert FaultSpec.from_dict(spec.to_dict()) == spec
        with pytest.raises(ValueError, match="unknown FaultSpec field"):
            FaultSpec.from_dict({"bogus": 1})
        for kind in FAULT_KINDS:
            out = spec.cleared(kind)
            assert out != spec
            # exactly one kind reset; the original is untouched
            diff = {
                k
                for k, v in out.to_dict().items()
                if spec.to_dict()[k] != v
            }
            assert diff, f"cleared({kind!r}) changed nothing"
            assert spec.chaos_drop_ratio == 0.25
        with pytest.raises(ValueError, match="unknown fault kind"):
            spec.cleared("gravity")

    def test_clear_fault_kind_leaves_siblings_firing_and_counting(self):
        """The composed partial-clear seam: two
        FaultSpecs layer chaos drops under latency across two apply
        calls; clearing the latency KIND mid-session leaves the chaos
        knobs armed, keeps the chaos counter climbing, and never
        resets any tally — including the cleared kind's own."""
        store = InMemoryCluster()
        facade = ApiServerFacade(store)
        FaultSpec(chaos_drop_ratio=0.4, chaos_seed=11).apply(facade)
        FaultSpec(
            request_latency_seconds=0.001, latency_seed=2
        ).apply(facade)
        cls = facade._handler_cls
        assert cls.chaos_drop_ratio == 0.4
        assert cls.request_latency_seconds == 0.001
        facade.start()
        try:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=5.0)
            store.create({"kind": "Node", "metadata": {"name": "n0"}})

            def drive(n: int) -> None:
                for _ in range(n):
                    try:
                        client.get("Node", "n0")
                    except OSError:
                        pass  # a chaos drop surfaced to the client

            drive(20)
            counters = facade.fault_counters
            assert counters["chaos_drops"] >= 1
            assert counters["delayed_requests"] >= 1
            chaos_before = counters["chaos_drops"]
            delayed_before = counters["delayed_requests"]
            facade.clear_fault_kind("latency")
            # the latency knobs are off, the sibling's untouched...
            assert cls.request_latency_seconds == 0.0
            assert cls.latency_rng is None
            assert cls.chaos_drop_ratio == 0.4
            assert cls.chaos_rng is not None
            # ...and no counter was reset by the clear
            assert counters["chaos_drops"] == chaos_before
            assert counters["delayed_requests"] == delayed_before
            drive(20)
            # the sibling kind keeps firing AND counting; the cleared
            # kind's tally stands as evidence but stops climbing
            assert counters["chaos_drops"] > chaos_before
            assert counters["delayed_requests"] == delayed_before
        finally:
            facade.stop()


# ---------------------------------------------------------------- checker
def _policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def _store_with_nodes(states: dict) -> InMemoryCluster:
    store = InMemoryCluster()
    key = util.get_upgrade_state_label_key()
    for name, state in states.items():
        store.create(
            {
                "kind": "Node",
                "metadata": {
                    "name": name,
                    "labels": {key: state} if state else {},
                },
            }
        )
    return store


class TestInvariantChecker:
    def test_healthy_final_state_passes(self):
        store = _store_with_nodes(
            {"a": consts.UPGRADE_STATE_DONE, "b": consts.UPGRADE_STATE_DONE}
        )
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a", "b"},
            policy=_policy(),
            decisions=[],
            converged=True,
        )
        assert out == []

    def test_lost_node_and_unknown_state_flagged(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        store.create(
            {
                "kind": "Node",
                "metadata": {
                    "name": "weird",
                    "labels": {
                        util.get_upgrade_state_label_key(): "not-a-state"
                    },
                },
            }
        )
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a", "gone", "weird"},
            policy=_policy(),
            decisions=[],
            converged=True,
        )
        found = {v.invariant for v in out}
        assert found == {"no-lost-nodes"}
        assert any("gone" in v.detail for v in out)
        assert any("not-a-state" in v.detail for v in out)

    def test_illegal_transition_and_monotone_violation_flagged(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        tape = chaos.AuditTape(store, _policy())
        # forged tape: an undefined edge, and a node leaving done in the
        # final era (no CR writes -> era starts at 0)
        tape.transitions = [
            (5, "a", "", consts.UPGRADE_STATE_DONE),
            (9, "a", consts.UPGRADE_STATE_DONE, "drain-required"),
        ]
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[],
            tape=tape,
            converged=True,
        )
        found = {v.invariant for v in out}
        assert "transition-legality" in found
        assert "monotone-completion" in found

    def test_unplanned_audit_gap_flagged_unless_expected(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        tape = chaos.AuditTape(store, _policy())
        tape.gaps = 2
        out = chaos.check_rollout_invariants(
            store, managed_nodes={"a"}, policy=_policy(), decisions=[],
            tape=tape, converged=True,
        )
        assert {v.invariant for v in out} == {"audit-continuity"}
        out = chaos.check_rollout_invariants(
            store, managed_nodes={"a"}, policy=_policy(), decisions=[],
            tape=tape, converged=True, expect={"audit_gaps": True},
        )
        assert out == []

    def test_unknown_reason_and_type_flagged(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[
                {"type": "NodeDeferred", "reason": "made-up", "target": "a"},
                {"type": "TotallyNew", "reason": "x", "target": "a"},
            ],
            converged=True,
        )
        assert [v.invariant for v in out] == [
            "decision-vocabulary",
            "decision-vocabulary",
        ]

    def test_reason_path_prerequisites(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        # a release without a quarantine is an audit-trail lie...
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[
                {
                    "type": events_mod.EVENT_QUARANTINE_RELEASED,
                    "reason": "repaired",
                    "target": "a",
                    "firstSeq": 5,
                }
            ],
            converged=True,
        )
        assert {v.invariant for v in out} == {"decision-path-legality"}
        # ...but NodeUnadmitted needs NO prior admission (the rollback
        # overtakes PENDING nodes the wave never reached)
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[
                {
                    "type": events_mod.EVENT_NODE_UNADMITTED,
                    "reason": events_mod.REASON_ROLLBACK_OVERTOOK,
                    "target": "a",
                    "firstSeq": 3,
                }
            ],
            converged=True,
        )
        assert out == []

    def test_unexplained_quarantine_flagged(self):
        store = InMemoryCluster()
        key = util.get_upgrade_state_label_key()
        store.create(
            {
                "kind": "Node",
                "metadata": {
                    "name": "q",
                    "labels": {key: consts.UPGRADE_STATE_FAILED},
                    "annotations": {
                        util.get_quarantine_annotation_key(): (
                            consts.REMEDIATION_QUARANTINE_PREFIX + "x"
                        )
                    },
                },
            }
        )
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"q"},
            policy=_policy(),
            decisions=[],
            converged=True,
        )
        assert {v.invariant for v in out} == {"terminal-states-explained"}
        # with the NodeQuarantined decision in the stream, it passes
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"q"},
            policy=_policy(),
            decisions=[
                {
                    "type": events_mod.EVENT_NODE_QUARANTINED,
                    "reason": "retry-budget",
                    "target": "q",
                    "firstSeq": 1,
                }
            ],
            converged=True,
        )
        assert out == []

    def test_open_breaker_flagged_unless_expected(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        store.create(
            {
                "kind": "DaemonSet",
                "metadata": {
                    "name": "ds",
                    "namespace": "ns",
                    "annotations": {
                        util.get_breaker_annotation_key(): json.dumps(
                            {"state": "open"}
                        )
                    },
                },
            }
        )
        kwargs = dict(
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[],
            ds_name="ds",
            ds_namespace="ns",
            converged=True,
        )
        out = chaos.check_rollout_invariants(store, **kwargs)
        assert {v.invariant for v in out} == {"breaker-episodes-closed"}
        out = chaos.check_rollout_invariants(
            store, expect={"breaker_open": True}, **kwargs
        )
        assert out == []

    def test_expected_rollback_missing_is_flagged(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        store.create(
            {"kind": "DaemonSet", "metadata": {"name": "ds", "namespace": "ns"}}
        )
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=[],
            ds_name="ds",
            ds_namespace="ns",
            target_revision="rev1",
            converged=True,
            expect={"rollback": True},
        )
        assert {v.invariant for v in out} == {"breaker-episodes-closed"}

    def test_stream_parity_persisted_must_be_subset(self):
        store = _store_with_nodes({"a": consts.UPGRADE_STATE_DONE})
        live = [
            {"type": "NodeAdmitted", "reason": "fresh", "target": "a",
             "firstSeq": 1}
        ]
        persisted = live + [
            {"type": "NodeDrained", "reason": "ok", "target": "ghost"}
        ]
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a"},
            policy=_policy(),
            decisions=live,
            persisted_decisions=persisted,
            converged=True,
        )
        assert {v.invariant for v in out} == {"stream-parity"}

    def test_unconverged_cell_names_pending_nodes(self):
        store = _store_with_nodes(
            {"a": consts.UPGRADE_STATE_DONE,
             "b": consts.UPGRADE_STATE_UPGRADE_REQUIRED}
        )
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"a", "b"},
            policy=_policy(),
            decisions=[],
            converged=False,
            target_revision="rev2",
        )
        assert {v.invariant for v in out} == {"converged"}
        assert any("b" in v.detail for v in out)


# --------------------------------------------------------------- campaigns
class TestCampaignFormat:
    def test_default_campaign_meets_the_acceptance_matrix(self):
        """≥ 8 distinct fault scenarios crossed with ≥ 2 config axes."""
        campaign = chaos.Campaign()
        cells = campaign.cells()
        assert len(set(c[0] for c in cells)) >= 8
        assert len(set(c[1] for c in cells)) == 2  # transport axis
        assert len(set(c[2] for c in cells)) == 2  # gates axis
        assert len(cells) >= 14

    def test_cell_seeds_are_stable_and_distinct(self):
        a = chaos.cell_seed(1, "apiserver-brownout", "http", "on", 8)
        assert a == chaos.cell_seed(1, "apiserver-brownout", "http", "on", 8)
        others = {
            chaos.cell_seed(1, "apiserver-brownout", "http", "off", 8),
            chaos.cell_seed(1, "apiserver-brownout", "inmem", "on", 8),
            chaos.cell_seed(2, "apiserver-brownout", "http", "on", 8),
            chaos.cell_seed(1, "policy-edits", "http", "on", 8),
        }
        assert a not in others and len(others) == 4

    def test_empty_intermediate_log_does_not_reset_the_seq_rebase(self):
        """Review regression: a replacement process that died before
        emitting anything leaves an empty log in the chain; the merge
        must carry the high-water mark past it, not re-base the next
        process's sequences over the first's."""
        first = events_mod.DecisionEventLog()
        first.emit("NodeUpgradeFailed", "attempt-failed", "n0")
        first.emit("NodeUpgradeFailed", "attempt-failed", "n0")
        empty = events_mod.DecisionEventLog()  # crashed before deciding
        third = events_mod.DecisionEventLog()
        third.emit("NodeRetried", "resync", "n0")
        merged = chaos.merge_decision_streams([first, empty, third])
        assert [d["type"] for d in merged] == [
            "NodeUpgradeFailed",
            "NodeRetried",
        ]
        assert merged[1]["firstSeq"] > merged[0]["seq"]
        # and the prerequisite judgment over the merged stream holds
        store = _store_with_nodes({"n0": consts.UPGRADE_STATE_DONE})
        out = chaos.check_rollout_invariants(
            store,
            managed_nodes={"n0"},
            policy=_policy(),
            decisions=merged,
            converged=True,
        )
        assert out == []

    def test_cell_construction_failure_restores_process_defaults(self):
        """Review regression: a cell that dies mid-construction (here:
        a scenario setup raising) must restore the swapped process
        defaults instead of leaking its cell-local registry/log."""
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.upgrade import timeline as timeline_mod

        registry = metrics.default_registry()
        log = events_mod.default_log()
        recorder = timeline_mod.default_recorder()
        broken = chaos.Scenario(
            name="broken-setup",
            description="",
            setup=lambda cell: (_ for _ in ()).throw(RuntimeError("boom")),
        )
        with pytest.raises(RuntimeError):
            chaos.CampaignCell(broken, "inmem", "off", 3, 1)
        assert metrics.default_registry() is registry
        assert events_mod.default_log() is log
        assert timeline_mod.default_recorder() is recorder

    def test_campaign_file_explicit_empties_are_errors(self):
        """Review regression: '\"scenarios\": []' means zero scenarios,
        not 'run the whole catalog'."""
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"scenarios": []})
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"axes": {"transport": []}})
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"fleet": 0})

    def test_evidence_is_part_of_the_violation_vocabulary(self):
        assert "evidence" in chaos.INVARIANTS

    def test_campaign_file_round_trip_and_validation(self):
        campaign = chaos.campaign_from_dict(
            {
                "name": "nightly",
                "seed": 7,
                "fleet": 5,
                "scenarios": ["policy-edits", "ha-failover"],
                "axes": {"transport": ["inmem"], "gates": ["on", "off"]},
            }
        )
        assert campaign.name == "nightly"
        assert campaign.seed == 7
        assert campaign.fleet_size == 5
        # 2 scenarios x inmem x (on, off) x (polling, event) — the
        # driver axis defaults into the matrix
        assert len(campaign.cells()) == 8
        assert len(
            [c for c in campaign.cells() if c[3] == "polling"]
        ) == 4
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"scenarios": ["no-such-scenario"]})
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"axes": {"transport": ["carrier"]}})

    def test_scenario_catalog_covers_issue_scenarios(self):
        """The campaign's scenario list, by name."""
        names = set(chaos.SCENARIOS)
        for required in (
            "apiserver-brownout",
            "informer-partition",
            "held-stream-truncation",
            "clock-skew",
            "journal-410-storm",
            "batch-endpoint-404",
            "ha-failover",
            "policy-edits",
            "event-gc-race",
            "bad-revision-rollback",
        ):
            assert required in names, required


class TestCampaignRuns:
    def test_inmem_cell_end_to_end_passes_and_audits(self):
        scenario = chaos.SCENARIOS["policy-edits"]
        seed = chaos.cell_seed(0, scenario.name, "inmem", "on", 5)
        row = chaos.run_cell(scenario, "inmem", "on", 5, seed)
        assert row["passed"], row["violations"]
        assert row["converged"]
        assert row["decisions"] > 0
        assert row["transitions"] > 0

    def test_same_seed_same_scorecard(self):
        campaign = chaos.Campaign(
            name="det",
            seed=3,
            fleet_size=4,
            scenarios=("policy-edits", "ha-failover"),
            transports=("inmem",),
        )
        first = chaos.run_campaign(campaign)
        second = chaos.run_campaign(campaign)
        assert chaos.deterministic_scorecard(
            first
        ) == chaos.deterministic_scorecard(second)
        assert first["cells_failed"] == 0

    def test_gc_race_cell_keeps_the_audit_trail(self):
        """The Event-GC race scenario end-to-end: sweeps + a mid-wave
        operator restart, with stream parity and the terminal-state
        explanations still green."""
        scenario = chaos.SCENARIOS["event-gc-race"]
        seed = chaos.cell_seed(0, scenario.name, "inmem", "on", 5)
        row = chaos.run_cell(scenario, "inmem", "on", 5, seed)
        assert row["passed"], row["violations"]

    def test_compact_scorecard_carries_the_tracked_keys(self):
        campaign = chaos.Campaign(
            seed=0, fleet_size=4, scenarios=("policy-edits",),
            transports=("inmem",), gates=("off",),
        )
        compact = chaos.compact_scorecard(chaos.run_campaign(campaign))
        for key in (
            "chaos_cells_passed",
            "chaos_cells_total",
            "chaos_scenarios",
            "chaos_violations",
            "chaos_wall_s",
        ):
            assert key in compact, key
        assert "chaos_failed_cells" not in compact  # nothing failed


class TestDriverAxis:
    """The event-driven-vs-polling reconcile driver
    is a first-class campaign axis (ROADMAP item 5 leftover)."""

    def test_default_matrix_includes_both_drivers(self):
        cells = chaos.Campaign().cells()
        drivers = {c[3] for c in cells}
        assert drivers == {"polling", "event"}
        # the event axis probes scheduling (transport-independent):
        # inmem cells only, so the matrix does not double on transport
        for name, transport, gates, driver in cells:
            if driver == "event":
                assert transport == "inmem"

    def test_polling_seed_unchanged_event_distinct(self):
        legacy = chaos.cell_seed(1, "policy-edits", "inmem", "on", 8)
        assert legacy == chaos.cell_seed(
            1, "policy-edits", "inmem", "on", 8, "polling"
        )
        assert legacy != chaos.cell_seed(
            1, "policy-edits", "inmem", "on", 8, "event"
        )

    def test_event_cell_end_to_end(self):
        scenario = chaos.SCENARIOS["policy-edits"]
        seed = chaos.cell_seed(0, scenario.name, "inmem", "on", 5, "event")
        row = chaos.run_cell(
            scenario, "inmem", "on", 5, seed, driver="event"
        )
        assert row["passed"], row["violations"]
        assert row["converged"]
        assert row["driver"] == "event"
        # the wakeup machinery demonstrably drove the passes
        assert row["wakeups"].get("watch", 0) > 0

    def test_campaign_file_driver_axis(self):
        campaign = chaos.campaign_from_dict(
            {
                "scenarios": ["policy-edits"],
                "axes": {"transport": ["inmem"], "driver": ["event"]},
            }
        )
        assert all(c[3] == "event" for c in campaign.cells())
        with pytest.raises(ValueError):
            chaos.campaign_from_dict({"axes": {"driver": ["cron"]}})

    def test_event_cell_skips_idle_cycles(self):
        """A gated fleet in event mode must actually SKIP cycles (the
        whole point of the axis): gates=on defers admissions, so some
        cycles arrive with no wakeup pending."""
        scenario = chaos.SCENARIOS["policy-edits"]
        seed = chaos.cell_seed(0, scenario.name, "inmem", "on", 4, "event")
        cell = chaos.CampaignCell(
            scenario, "inmem", "on", 4, seed, driver="event"
        )
        try:
            ran = 0
            skipped = 0
            for _ in range(8):
                if cell.begin_cycle():
                    cell.end_cycle()
                    ran += 1
                else:
                    skipped += 1
            # first cycle sees the seeded store (journal advance) and
            # runs; later cycles with no new deltas skip until the
            # fallback fires (every 4th quiet cycle)
            assert ran >= 1
            assert skipped >= 1
        finally:
            cell.close()


# ------------------------------------------------- against the JAX package


def _package(name: str):
    """The modules of one package that a chaos cell touches."""
    import importlib

    return {m: importlib.import_module(f"{name}.{m}") for m in (
        "metrics", "cluster.inmem", "obs.events", "upgrade.chaos", "upgrade.consts",
        "upgrade.timeline", "upgrade.upgrade_state", "upgrade.util",
    )}


def _tampered_violations(name: str, seed: int) -> list:
    """A 6-node SimFleet taken to rev2 by *name*'s manager, then tampered
    with from *seed* (a managed node deleted, one node's state label set
    to a state no processor writes after done, one left cordoned), and
    the checker's violations, by invariant and detail."""
    import random

    pkg = _package(name)
    chaos_mod, events, util_mod = pkg["upgrade.chaos"], pkg["obs.events"], pkg["upgrade.util"]
    prev = (
        pkg["metrics"].set_default_registry(pkg["metrics"].MetricsRegistry()),
        events.set_default_log(events.DecisionEventLog()),
        pkg["upgrade.timeline"].set_default_recorder(pkg["upgrade.timeline"].FlightRecorder()),
    )
    store = pkg["cluster.inmem"].InMemoryCluster()
    fleet = chaos_mod.SimFleet(store, 6)
    policy = chaos_mod._campaign_policy("on")
    tape = chaos_mod.AuditTape(store, policy)
    manager = pkg["upgrade.upgrade_state"].ClusterUpgradeStateManager(
        store, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.005)
    try:
        fleet.publish("rev2")
        for _ in range(80):
            manager.apply_state(manager.build_state(fleet.NAMESPACE, fleet.LABELS), policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile()
            tape.collect()
            if fleet.converged("rev2"):
                break
        assert fleet.converged("rev2")
        rng = random.Random(seed)
        lost, illegal, cordoned = rng.sample(sorted(fleet.managed_nodes), 3)
        store.delete("Node", lost)
        state = rng.choice([pkg["upgrade.consts"].UPGRADE_STATE_DRAIN_REQUIRED,
                            pkg["upgrade.consts"].UPGRADE_STATE_CORDON_REQUIRED,
                            pkg["upgrade.consts"].UPGRADE_STATE_POD_RESTART_REQUIRED])
        store.patch("Node", illegal,
                    {"metadata": {"labels": {util_mod.get_upgrade_state_label_key(): state}}})
        store.patch("Node", cordoned, {"spec": {"unschedulable": True}})
        tape.collect()
        found = chaos_mod.check_rollout_invariants(
            store, managed_nodes=fleet.managed_nodes, policy=policy,
            decisions=events.default_log().export_stream(), tape=tape,
            ds_name=fleet.DS_NAME, ds_namespace=fleet.NAMESPACE,
            target_revision="rev2", converged=True,
        )
    finally:
        manager.shutdown()
        pkg["metrics"].set_default_registry(prev[0])
        events.set_default_log(prev[1])
        pkg["upgrade.timeline"].set_default_recorder(prev[2])
    return sorted((v.invariant, v.detail) for v in found)


class TestAgainstJax:
    """The port's campaign engine and checker against the JAX package's,
    from the same seeds, exact after ``to_port_vocab``."""

    def test_a_reduced_campaign_scores_as_the_jax_one(self):
        from k8s_operator_libs_tpu.upgrade import chaos as jchaos

        from test_torch_vocab import to_port_vocab

        axes = dict(
            name="diff", seed=3, fleet_size=5,
            scenarios=("apiserver-brownout", "policy-edits", "federated-cell-brownout"),
            transports=("inmem", "http"), gates=("on", "off"), drivers=("polling",),
        )
        jax_card = jchaos.deterministic_scorecard(jchaos.run_campaign(jchaos.Campaign(**axes)))
        port_card = chaos.deterministic_scorecard(chaos.run_campaign(chaos.Campaign(**axes)))
        assert port_card == to_port_vocab(jax_card)
        cells = port_card["cells"]
        assert {c["transport"] for c in cells} == {"inmem", "http"}
        assert {c["gates"] for c in cells} == {"on", "off"}
        assert "federated-cell-brownout" in {c["scenario"] for c in cells}
        assert port_card["cells_failed"] == 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_the_checker_names_the_jax_violations_on_a_tampered_cluster(self, seed):
        from test_torch_vocab import to_port_vocab

        port = _tampered_violations("k8s_operator_libs_tpu_torch", seed)
        assert port == to_port_vocab(_tampered_violations("k8s_operator_libs_tpu", seed))
        assert {"no-lost-nodes", "transition-legality"} <= {v for v, _ in port}

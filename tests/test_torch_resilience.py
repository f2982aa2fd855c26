"""Chaos / property suite: crash-resume idempotency and throttle
invariants under randomized fleets, crash points, and interleavings.

The reference's core resilience claim is architectural, not tested: all
state lives in node labels/annotations so an operator restart resumes
mid-upgrade for free (upgrade_state.go:49-50), and idempotent processing
makes double-running reconcilers safe.  The reference suite never probes
either (SURVEY.md §5: no race detection, no fault injection).  This suite
does, the property-based way:

* **crash-resume** — an injected fault truncates the reconcile's write
  sequence after a random number of mutations (the operator dying
  mid-ApplyState); a *fresh* manager over the same cluster must pick up
  from the half-written labels and still converge;
* **throttle invariants** — at every settled point of every randomized
  rollout, the fleet never exceeds the resolved maxUnavailable budget and
  never runs more concurrent upgrades than maxParallelUpgrades, in node
  units or slice-domain units per policy;
* **split-brain** — two managers (an HA operator pair that both think
  they lead) interleave reconciles over one cluster; idempotency must
  keep the invariants and convergence intact.

Seeds are fixed per spec for reproducibility.


Every class of ``tests/test_resilience.py``, as cases of the same names, on the
port (``k8s_operator_libs_tpu_torch``) in its GPU-fleet vocabulary."""

import random
import threading
import time

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InformerCache, InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import (
    node_is_ready,
    node_is_unschedulable,
)
from k8s_operator_libs_tpu_torch.tpu import topology
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import (
    DRIVER_LABELS,
    NAMESPACE,
    Fleet,
    daemonset_loop,
    wait_for_converged,
)
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
GROUP_KEY = consts.MULTISLICE_GROUP_LABEL_KEYS[0]

IDLE_STATES = ("", consts.UPGRADE_STATE_DONE, consts.UPGRADE_STATE_UPGRADE_REQUIRED)


class SimulatedCrash(RuntimeError):
    """The injected operator death."""


class CrashingCluster:
    """Wraps an :class:`InMemoryCluster`; after an armed budget of mutating
    calls *from the arming thread* it raises :class:`SimulatedCrash`,
    truncating the reconcile's write sequence exactly where an operator
    crash would.  Background drain/eviction threads are exempt — they die
    with the old manager via ``wait_idle`` in the driver loop instead."""

    _MUTATORS = frozenset({"create", "update", "patch", "delete", "evict"})

    def __init__(self, inner: InMemoryCluster):
        self._inner = inner
        self._budget = None
        self._thread = None

    def arm(self, budget: int) -> None:
        self._budget = budget
        self._thread = threading.get_ident()

    def disarm(self) -> None:
        self._budget = None

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self._MUTATORS:

            def wrapped(*args, **kwargs):
                if (
                    self._budget is not None
                    and threading.get_ident() == self._thread
                ):
                    if self._budget <= 0:
                        raise SimulatedCrash(f"crashed before {name}")
                    self._budget -= 1
                return attr(*args, **kwargs)

            return wrapped
        return attr


def build_random_fleet(rng: random.Random, cluster) -> Fleet:
    """2-3 slices x 2-3 hosts plus 0-2 singletons, all out of date.
    Half the time the first two slices are DCN-coupled into one
    multislice job group (their nodes then form a single atomic domain)."""
    fleet = Fleet(cluster)
    n_slices = rng.randint(2, 3)
    multislice = rng.random() < 0.5
    for s in range(n_slices):
        labels = {SLICE_KEY: f"slice-{s}"}
        if multislice and s < 2:
            labels[GROUP_KEY] = "job-A"
        for h in range(rng.randint(2, 3)):
            fleet.add_node(f"s{s}-h{h}", pod_hash="rev1", labels=dict(labels))
    for i in range(rng.randint(0, 2)):
        fleet.add_node(f"solo{i}", pod_hash="rev1")
    fleet.publish_new_revision("rev2")
    return fleet


def random_policy(rng: random.Random) -> UpgradePolicySpec:
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=rng.choice([0, 1, 2]),
        max_unavailable=IntOrString(rng.choice([1, 2, "25%", "50%"])),
        slice_aware=rng.choice([True, False]),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )


def make_manager(
    cluster, lag_seconds: float = 0.0, cascade: bool = False
) -> ClusterUpgradeStateManager:
    return ClusterUpgradeStateManager(
        cluster,
        cache=InformerCache(cluster, lag_seconds=lag_seconds),
        cascade=cascade,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005,
    )


def check_invariants(cluster, policy: UpgradePolicySpec) -> None:
    """Never more unavailable capacity than the budget, never more
    concurrent upgrades than maxParallelUpgrades — in the policy's units."""
    nodes = cluster.list("Node")
    state_key = util.get_upgrade_state_label_key()

    def node_state(n):
        return (n["metadata"].get("labels") or {}).get(state_key, "")

    active = [n for n in nodes if node_state(n) not in IDLE_STATES]
    unavailable = [
        n for n in nodes if node_is_unschedulable(n) or not node_is_ready(n)
    ]
    if policy.slice_aware:
        total = topology.count_domains(nodes)
        n_active = len({topology.domain_of(n) for n in active})
        n_unavailable = len({topology.domain_of(n) for n in unavailable})
    else:
        total = len(nodes)
        n_active = len(active)
        n_unavailable = len(unavailable)

    budget = policy.max_unavailable.scaled_value(total, round_up=True)
    assert n_unavailable <= budget, (
        f"{n_unavailable} unavailable exceeds maxUnavailable={budget} "
        f"(slice_aware={policy.slice_aware})"
    )
    if policy.max_parallel_upgrades > 0:
        assert n_active <= policy.max_parallel_upgrades, (
            f"{n_active} concurrent upgrades exceed "
            f"maxParallelUpgrades={policy.max_parallel_upgrades}"
        )


def drive(
    manager,
    fleet,
    policy,
    cluster,
    *,
    rng=None,
    crashing=None,
    lag_seconds: float = 0.0,
    max_cycles: int = 80,
    managers=None,
) -> bool:
    """Reconcile until the whole fleet is upgrade-done at the new revision.

    Each cycle optionally arms a random crash budget; a crash swaps in a
    fresh manager (operator restart).  When *managers* is given, each
    cycle's reconcile is run by a randomly chosen manager (split-brain).
    """
    for _ in range(max_cycles):
        active = rng.choice(managers) if managers else manager
        try:
            if crashing is not None and rng.random() < 0.5:
                crashing.arm(rng.randint(0, 6))
            state = active.build_state(NAMESPACE, DRIVER_LABELS)
            active.apply_state(state, policy)
        except SimulatedCrash:
            pass
        finally:
            if crashing is not None:
                crashing.disarm()
        active.drain_manager.wait_idle(10.0)
        active.pod_manager.wait_idle(10.0)
        if crashing is not None:
            # the crashed operator is replaced by a fresh process: new
            # manager, new informer cache, no in-memory carry-over; the
            # replacement may or may not run the pipelined cascade
            manager = make_manager(
                cluster,
                lag_seconds=lag_seconds,
                cascade=rng.choice([True, False]),
            )
        fleet.reconcile_daemonset()
        check_invariants(cluster, policy)
        states = set(fleet.states().values())
        if states == {consts.UPGRADE_STATE_DONE}:
            return True
    return False


def assert_all_pods_at(cluster, revision_hash: str) -> None:
    for pod in cluster.list("Pod", namespace=NAMESPACE):
        assert (
            pod["metadata"]["labels"]["controller-revision-hash"]
            == revision_hash
        )


class TestCrashResume:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_crash_points_still_converge(self, seed):
        rng = random.Random(seed)
        inner = InMemoryCluster()
        cluster = CrashingCluster(inner)
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster)
        assert drive(
            manager, fleet, policy, cluster, rng=rng, crashing=cluster
        ), f"seed {seed} did not converge: {fleet.states()}"
        assert_all_pods_at(inner, "rev2")

    @pytest.mark.parametrize("seed", range(2))
    def test_crash_resume_with_lagged_informer_cache(self, seed):
        """Restarted operators resume from a *stale* cache: the
        cache-visibility wait must keep half-written state from being
        processed twice (node_upgrade_state_provider.go:100-117)."""
        rng = random.Random(1000 + seed)
        inner = InMemoryCluster()
        cluster = CrashingCluster(inner)
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster, lag_seconds=0.02)
        assert drive(
            manager,
            fleet,
            policy,
            cluster,
            rng=rng,
            crashing=cluster,
            lag_seconds=0.02,
        ), f"seed {seed} did not converge: {fleet.states()}"
        assert_all_pods_at(inner, "rev2")


class TestThrottleInvariantsProperty:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_fleets_never_exceed_budgets(self, seed):
        rng = random.Random(2000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster, cascade=rng.choice([True, False]))
        assert drive(
            manager, fleet, policy, cluster, rng=rng
        ), f"seed {seed} did not converge: {fleet.states()}"
        assert_all_pods_at(cluster, "rev2")


class TestControllerCrashResume:
    """Kill the whole event-driven operator (controller + manager + its
    informer cache) mid-rollout and boot a replacement: the label-resident
    state must let the new operator pick up exactly where the old one
    died — the end-to-end version of the crash-resume property, through
    the controller runtime instead of a manual reconcile loop."""

    @pytest.mark.parametrize("seed", range(3))
    def test_operator_restart_mid_rollout_converges(self, seed):
        import time as _time

        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller

        rng = random.Random(4000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)

        def boot():
            manager = make_manager(cluster)
            return manager, new_upgrade_controller(
                cluster, manager, NAMESPACE, DRIVER_LABELS, policy,
                resync_seconds=0.1, active_requeue_seconds=0.02,
            )

        with daemonset_loop(fleet):
            manager, ctrl = boot()
            ctrl.start()
            try:
                # let the first operator make some progress, then kill it
                # at a random point.  Python threads can't be killed, so
                # the dead operator's async drain/eviction workers are
                # drained to completion instead — the settled-point
                # approximation of a whole-process death (every other
                # invariant check in this suite is likewise post-wait_idle).
                _time.sleep(rng.uniform(0.05, 0.4))
                ctrl.stop(timeout=5.0)
                manager.drain_manager.wait_idle(10.0)
                manager.pod_manager.wait_idle(10.0)
                check_invariants(cluster, policy)

                manager, ctrl = boot()  # the replacement process
                ctrl.start()
                assert wait_for_converged(fleet), (
                    f"seed {seed} did not converge after restart: "
                    f"{fleet.states()}"
                )
                check_invariants(cluster, policy)
                assert_all_pods_at(cluster, "rev2")
            finally:
                ctrl.stop()


class TestSplitBrain:
    @pytest.mark.parametrize("seed", range(4))
    def test_two_managers_interleaved(self, seed):
        """An HA pair where both replicas reconcile: label-idempotency
        must make the duplicate processing harmless."""
        rng = random.Random(3000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        # one replica pipelines, the other doesn't — the worst mismatch
        managers = [
            make_manager(cluster, cascade=True),
            make_manager(cluster, cascade=False),
        ]
        assert drive(
            None, fleet, policy, cluster, rng=rng, managers=managers
        ), f"seed {seed} did not converge: {fleet.states()}"
        assert_all_pods_at(cluster, "rev2")


# ---------------------------------------------------------------------------
# Transition legality: every observed state-label change rides a legal edge
# of the reference's lifecycle graph (SURVEY.md §2 state diagram).  The edge
# set and the journal reader are the CANONICAL ones from upgrade/chaos.py —
# the chaos campaign's rollout-invariant checker and this property suite
# must judge the same graph, so there is exactly one definition.
# ---------------------------------------------------------------------------

from k8s_operator_libs_tpu_torch.upgrade.chaos import (  # noqa: E402
    LEGAL_TRANSITIONS,
    observed_transitions,
)


class TestTransitionLegality:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_rollouts_only_ride_legal_edges(self, seed):
        rng = random.Random(5000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster, cascade=rng.choice([True, False]))
        assert drive(manager, fleet, policy, cluster, rng=rng)
        illegal = [
            t
            for t in observed_transitions(cluster)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"

    @pytest.mark.parametrize("seed", range(3))
    def test_crashes_never_produce_illegal_edges(self, seed):
        """An operator dying mid-write must never leave a node having
        jumped an edge the lifecycle does not define."""
        rng = random.Random(6000 + seed)
        inner = InMemoryCluster()
        cluster = CrashingCluster(inner)
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster)
        assert drive(manager, fleet, policy, cluster, rng=rng, crashing=cluster)
        illegal = [
            t
            for t in observed_transitions(inner)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"


# ---------------------------------------------------------------------------
# Failure injection: driver restart storms and node flapping mid-rollout.
# The chaos above only kills the operator; this kills the *fleet*.
# ---------------------------------------------------------------------------


class TestFailureInjectionChaos:
    def _storm(self, cluster, rng) -> bool:
        """Pick a random driver pod and put it into a restart storm (not
        ready, restartCount past the >10 threshold of
        common_manager.go:636-648)."""
        pods = cluster.list("Pod", namespace=NAMESPACE)
        if not pods:
            return False
        pod = rng.choice(pods)
        pod["status"]["containerStatuses"] = [
            {"name": "driver", "ready": False, "restartCount": 11}
        ]
        cluster.update(pod)
        return True

    # NOTE: whether a storm surfaces as upgrade-failed depends on the
    # stormed node's bucket (detection runs in the pod-restart phase);
    # the detector itself is covered by TestPodRestart* specs — here the
    # property is convergence + edge legality despite the storms.

    def _heal_storms(self, cluster, fleet):
        """Ops replaces the sick pods: delete them; the DS controller
        recreates at the current revision, ready."""
        for pod in cluster.list("Pod", namespace=NAMESPACE):
            statuses = pod["status"].get("containerStatuses") or []
            if any(
                not s.get("ready") and s.get("restartCount", 0) > 10
                for s in statuses
            ):
                cluster.delete(
                    "Pod", pod["metadata"]["name"], pod["metadata"]["namespace"]
                )
        fleet.reconcile_daemonset()

    def _flap(self, cluster, rng):
        nodes = cluster.list("Node")
        node = rng.choice(nodes)
        from k8s_operator_libs_tpu_torch.cluster.objects import set_condition

        set_condition(node, "Ready", "False")
        cluster.update(node)
        return node["metadata"]["name"]

    def _unflap(self, cluster, name):
        from k8s_operator_libs_tpu_torch.cluster.objects import set_condition

        node = cluster.get("Node", name)
        set_condition(node, "Ready", "True")
        cluster.update(node)

    @pytest.mark.parametrize("seed", range(6))
    def test_storms_and_flaps_still_converge(self, seed):
        rng = random.Random(7000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        policy = random_policy(rng)
        manager = make_manager(cluster, cascade=rng.choice([True, False]))
        flapped = None
        for cycle in range(120):
            # inject: restart storm or node flap, at random, then heal a
            # few cycles later — the invariant check runs only on clean
            # cycles (injected unavailability is the *environment's* doing;
            # the throttle adapts to it rather than being bounded by it)
            if flapped is None and rng.random() < 0.2:
                flapped = self._flap(cluster, rng)
            elif flapped is not None and rng.random() < 0.5:
                self._unflap(cluster, flapped)
                flapped = None
            stormed = rng.random() < 0.2 and self._storm(cluster, rng)
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            if stormed:
                self._heal_storms(cluster, fleet)
            fleet.reconcile_daemonset()
            if flapped is None:
                check_invariants(cluster, policy)
            states = set(fleet.states().values())
            if states == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail(f"seed {seed} did not converge: {fleet.states()}")
        assert_all_pods_at(cluster, "rev2")
        # every observed edge legal even under injected failures
        illegal = [
            t
            for t in observed_transitions(cluster)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"


# ---------------------------------------------------------------------------
# Slice-coherent chaos: randomized fleets where every recreated driver pod
# runs the safe-load init-container protocol; no host may ever be released
# while a domain peer's pod is still at the old revision.
# ---------------------------------------------------------------------------


class SafeLoadInitContainers:
    """Simulates each driver pod's init container: a recreated pod at the
    new revision blocks (safe-load annotation + not ready) until the state
    machine unblocks it, then reports ready.  Records the revision mix of
    the released node's *domain peers* at release time."""

    def __init__(self, cluster, fleet):
        self.cluster = cluster
        self.fleet = fleet
        self.safe_key = util.get_wait_for_safe_load_annotation_key()
        self.torn_releases = []
        self.releases = 0

    def step(self, target_rev: str) -> None:
        pods = {
            p["spec"]["nodeName"]: p
            for p in self.cluster.list("Pod", namespace=NAMESPACE)
        }
        for node_name, pod in pods.items():
            node = self.cluster.get("Node", node_name)
            ann = (node["metadata"].get("annotations")) or {}
            at_target = (
                pod["metadata"]["labels"].get("controller-revision-hash")
                == target_rev
            )
            if not at_target:
                continue
            if pod["metadata"].get("_blocked") and self.safe_key not in ann:
                # released by the machine → init container proceeds
                pod["status"]["containerStatuses"] = [
                    {"name": "driver", "ready": True}
                ]
                pod["metadata"]["_blocked"] = False
                self.cluster.update(pod)
                self.releases += 1
                domain = topology.domain_of(node)
                for peer in self.cluster.list("Node"):
                    if (
                        topology.domain_of(peer) == domain
                        and peer["metadata"]["name"] in pods
                    ):
                        peer_rev = pods[peer["metadata"]["name"]][
                            "metadata"
                        ]["labels"].get("controller-revision-hash")
                        if peer_rev != target_rev:
                            self.torn_releases.append(
                                (node_name, peer["metadata"]["name"], peer_rev)
                            )
            elif (
                not pod["metadata"].get("_blocked")
                and "_init_seen" not in pod["metadata"]
            ):
                # fresh pod at the target revision → block on safe load
                pod["metadata"]["_init_seen"] = True
                pod["metadata"]["_blocked"] = True
                pod["status"]["containerStatuses"] = [
                    {"name": "driver", "ready": False}
                ]
                self.cluster.update(pod)
                self.cluster.patch(
                    "Node",
                    node_name,
                    {
                        "metadata": {
                            "annotations": {
                                self.safe_key: pod["metadata"]["name"]
                            }
                        }
                    },
                )


class TestSliceCoherentChaos:
    @pytest.mark.parametrize("seed", range(6))
    def test_no_torn_release_across_random_fleets(self, seed):
        rng = random.Random(8000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        sim = SafeLoadInitContainers(cluster, fleet)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=rng.choice([0, 1, 2]),
            max_unavailable=IntOrString(rng.choice([1, 2, "50%"])),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        manager = make_manager(
            cluster, cascade=rng.choice([True, False])
        ).with_slice_coherent_safe_load()
        for cycle in range(120):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            sim.step("rev2")
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail(f"seed {seed} did not converge: {fleet.states()}")
        assert sim.releases > 0
        assert sim.torn_releases == [], (
            f"seed {seed}: hosts released against old-revision peers: "
            f"{sim.torn_releases}"
        )
        assert_all_pods_at(cluster, "rev2")

    @pytest.mark.parametrize("seed", range(4))
    def test_no_torn_release_under_operator_crashes(self, seed):
        """Slice-coherent barrier + operator crashes: a crash can split a
        domain (one host admitted, the write for its peer lost).  The
        scheduler must admit the stragglers of an already-active domain
        without a slot, or the barrier-held half would wait forever on a
        peer the throttle never admits."""
        rng = random.Random(9000 + seed)
        inner = InMemoryCluster()
        cluster = CrashingCluster(inner)
        fleet = build_random_fleet(rng, cluster)
        sim = SafeLoadInitContainers(cluster, fleet)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=rng.choice([1, 2]),
            max_unavailable=IntOrString(rng.choice([1, "50%"])),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        for cycle in range(120):
            try:
                if rng.random() < 0.4:
                    cluster.arm(rng.randint(0, 6))
                state = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(state, policy)
            except SimulatedCrash:
                pass
            finally:
                cluster.disarm()
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            # replacement operator (fresh process) takes over
            manager = make_manager(cluster).with_slice_coherent_safe_load()
            fleet.reconcile_daemonset()
            sim.step("rev2")
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail(f"seed {seed} did not converge: {fleet.states()}")
        assert sim.torn_releases == [], (
            f"seed {seed}: torn releases {sim.torn_releases}"
        )
        assert_all_pods_at(inner, "rev2")

    def test_crash_split_domain_straggler_admitted_without_slot(self):
        """Deterministic regression of the wedge: h0 already in
        cordon-required (its domain active and pinning the only slot), h1
        of the same slice still upgrade-required.  The next reconcile must
        admit h1 anyway — same failure domain, already down."""
        cluster = InMemoryCluster()
        fleet = Fleet(cluster)
        fleet.add_node("s0-h0", pod_hash="rev1", labels={SLICE_KEY: "s0"})
        fleet.add_node("s0-h1", pod_hash="rev1", labels={SLICE_KEY: "s0"})
        fleet.publish_new_revision("rev2")
        state_key = util.get_upgrade_state_label_key()
        cluster.patch(
            "Node",
            "s0-h0",
            {"metadata": {"labels": {
                state_key: consts.UPGRADE_STATE_CORDON_REQUIRED}}},
        )
        cluster.patch(
            "Node",
            "s0-h1",
            {"metadata": {"labels": {
                state_key: consts.UPGRADE_STATE_UPGRADE_REQUIRED}}},
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,  # the active domain pins the only slot
            max_unavailable=IntOrString(1),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        assert fleet.node_state("s0-h1") != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        # and the whole rollout still converges
        for _ in range(40):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail(f"did not converge: {fleet.states()}")


# ---------------------------------------------------------------------------
# Policy mutations mid-rollout: live CR edits (the CrPolicySource path)
# arrive at arbitrary points.  The chaos above keeps ONE policy per
# scenario; real fleets shrink budgets, pause, and resume while nodes are
# mid-flight.  Property: the active set never GROWS past the policy in
# force at that moment — in-flight work finishes (a shrunk budget cannot
# retract an admitted slice) but nothing NEW is admitted beyond it, a
# paused rollout admits nothing, and the final (permissive) policy always
# converges the fleet.
# ---------------------------------------------------------------------------


def _active_units(cluster, slice_aware: bool) -> int:
    state_key = util.get_upgrade_state_label_key()
    nodes = cluster.list("Node")
    active = [
        n
        for n in nodes
        if (n["metadata"].get("labels") or {}).get(state_key, "")
        not in IDLE_STATES
    ]
    if slice_aware:
        return len({topology.domain_of(n) for n in active})
    return len(active)


def _unit_budget(cluster, policy: UpgradePolicySpec) -> float:
    """The number of units the policy in force allows to be active."""
    if not policy.auto_upgrade:
        return 0.0
    nodes = cluster.list("Node")
    total = topology.count_domains(nodes) if policy.slice_aware else len(nodes)
    budget = float(policy.max_unavailable.scaled_value(total, round_up=True))
    if policy.max_parallel_upgrades > 0:
        budget = min(budget, float(policy.max_parallel_upgrades))
    return budget


class TestPolicyMutationChaos:
    @pytest.mark.parametrize("seed", range(8))
    def test_policy_edits_mid_rollout_hold_going_forward(self, seed):
        rng = random.Random(9000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        # Unit semantics fixed per scenario: flipping slice_aware
        # mid-rollout redefines what a "unit" is and the non-growth
        # property would compare apples to slices.
        slice_aware = rng.random() < 0.5

        def fresh_policy(auto: bool = True) -> UpgradePolicySpec:
            return UpgradePolicySpec(
                auto_upgrade=auto,
                max_parallel_upgrades=rng.choice([0, 1, 2]),
                max_unavailable=IntOrString(rng.choice([1, 2, "25%", "50%"])),
                slice_aware=slice_aware,
                drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            )

        policy = fresh_policy()
        manager = make_manager(cluster)
        prev_active = 0
        mutations = 0
        for cycle in range(120):
            # after cycle 60 stop mutating and force a permissive policy
            # so convergence is always reachable
            if cycle == 60:
                policy = UpgradePolicySpec(
                    auto_upgrade=True,
                    max_parallel_upgrades=0,
                    max_unavailable=IntOrString("50%"),
                    slice_aware=slice_aware,
                    drain_spec=DrainSpec(
                        enable=True, force=True, timeout_second=10
                    ),
                )
            elif cycle and rng.random() < 0.2:
                policy = fresh_policy(auto=rng.random() > 0.25)
                mutations += 1
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            active = _active_units(cluster, slice_aware)
            allowed = max(float(prev_active), _unit_budget(cluster, policy))
            assert active <= allowed, (
                f"seed {seed} cycle {cycle}: active units grew to {active} "
                f"past {allowed} (policy maxParallel="
                f"{policy.max_parallel_upgrades} maxUnavailable="
                f"{policy.max_unavailable} auto={policy.auto_upgrade})"
            )
            prev_active = active
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail(
                f"seed {seed}: did not converge after {mutations} mutations: "
                f"{fleet.states()}"
            )
        # live edits never push a node across an undefined edge either
        illegal = [
            t
            for t in observed_transitions(cluster)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"

    @pytest.mark.parametrize("seed", range(3))
    def test_pause_resume_freezes_then_finishes(self, seed):
        """auto_upgrade=False mid-rollout: in-flight nodes may finish but
        the upgrade-required backlog must not shrink while paused; resume
        drains the backlog to done."""
        rng = random.Random(9100 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        running = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString(1),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        paused = UpgradePolicySpec(auto_upgrade=False)
        manager = make_manager(cluster)
        state_key = util.get_upgrade_state_label_key()

        def required() -> int:
            return sum(
                1
                for n in cluster.list("Node")
                if (n["metadata"].get("labels") or {}).get(state_key, "")
                == consts.UPGRADE_STATE_UPGRADE_REQUIRED
            )

        # run a few cycles, then pause
        for _ in range(rng.randint(2, 5)):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, running)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
        backlog = required()
        for _ in range(6):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, paused)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            assert required() >= backlog, "paused rollout admitted a node"
        # resume and converge
        for _ in range(80):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, running)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                return
        pytest.fail(f"seed {seed}: did not converge after resume")


# ---------------------------------------------------------------------------
# Remediation convergence: random fleets with an injected bad revision and
# autoRollback enabled always converge back to the last-known-good revision
# riding only legal state-machine edges — including crash-resume
# mid-rollback (the operator dying between the breaker trip, the
# ControllerRevision promotion, and the retry transitions).
# ---------------------------------------------------------------------------


class TestRemediationConvergence:
    def _remediation_policy(self, rng: random.Random) -> UpgradePolicySpec:
        from k8s_operator_libs_tpu_torch.api import RemediationSpec

        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=rng.choice([0, 1, 2]),
            max_unavailable=IntOrString(rng.choice([1, 2, "50%"])),
            slice_aware=rng.choice([True, False]),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            remediation=RemediationSpec(
                failure_threshold=0.5,
                min_attempted=1,
                auto_rollback=True,
                max_node_attempts=6,
                backoff_seconds=0.0,
            ),
        )

    def _drive_to_lkg(
        self,
        cluster,
        inner,
        fleet,
        policy,
        rng,
        crashing=None,
        cycles=160,
        check_budgets=True,
    ) -> None:
        state_key = util.get_upgrade_state_label_key()
        manager = make_manager(cluster)
        # healthy era first: the LKG tracker must observe rev1 as the
        # standing target before the bad revision lands
        for _ in range(3):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
        fleet.bad_revisions.add("rev2")
        fleet.publish_new_revision("rev2")
        for _ in range(cycles):
            try:
                if crashing is not None and rng.random() < 0.4:
                    crashing.arm(rng.randint(0, 6))
                state = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(state, policy)
            except SimulatedCrash:
                pass
            finally:
                if crashing is not None:
                    crashing.disarm()
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            if crashing is not None:
                # replacement operator process: fresh manager + cache
                manager = make_manager(cluster)
            fleet.reconcile_daemonset()
            if check_budgets:
                # the rollback wave obeys maxUnavailable/slice budgets
                # like any other wave (acceptance criterion)
                check_invariants(inner, policy)
            nodes = inner.list("Node")
            if nodes and all(
                (n["metadata"].get("labels") or {}).get(state_key)
                == consts.UPGRADE_STATE_DONE
                for n in nodes
            ) and all(
                p["metadata"]["labels"]["controller-revision-hash"] == "rev1"
                for p in inner.list("Pod", namespace=NAMESPACE)
            ):
                return
        pytest.fail(f"fleet did not converge to LKG: {fleet.states()}")

    @pytest.mark.parametrize("seed", range(5))
    def test_bad_revision_rolls_back_to_lkg(self, seed):
        rng = random.Random(11_000 + seed)
        cluster = InMemoryCluster()
        fleet = build_random_fleet(rng, cluster)
        # build_random_fleet already published rev2; rebuild a clean
        # rev1-era fleet instead: pods start in sync at rev1
        cluster = InMemoryCluster()
        fleet = Fleet(cluster)
        for s in range(rng.randint(2, 3)):
            for h in range(rng.randint(2, 3)):
                fleet.add_node(f"s{s}-h{h}", labels={SLICE_KEY: f"slice-{s}"})
        policy = self._remediation_policy(rng)
        self._drive_to_lkg(cluster, cluster, fleet, policy, rng)
        # the breaker demonstrably tripped and rolled back
        ds = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
        breaker_raw = (ds["metadata"].get("annotations") or {}).get(
            util.get_breaker_annotation_key()
        )
        lkg_raw = (ds["metadata"].get("annotations") or {}).get(
            util.get_last_known_good_annotation_key()
        )
        import json as _json

        assert lkg_raw and _json.loads(lkg_raw)["target"] == "rev1"
        if breaker_raw:  # may have retired once the wreckage cleaned
            assert _json.loads(breaker_raw)["state"] == "rolled-back"
        # every edge legal, including the remediation retry edge
        illegal = [
            t
            for t in observed_transitions(cluster)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"

    @pytest.mark.parametrize("seed", range(4))
    def test_rollback_survives_operator_crashes(self, seed):
        """Crash-resume mid-rollback: the operator dies at random write
        budgets (possibly between the trip, the ControllerRevision
        promotion, and the retry transitions); replacements must resume
        from the annotation-resident remediation state and still land
        the whole fleet back on the LKG revision."""
        rng = random.Random(12_000 + seed)
        inner = InMemoryCluster()
        cluster = CrashingCluster(inner)
        fleet = Fleet(cluster)
        for s in range(rng.randint(2, 3)):
            for h in range(rng.randint(2, 3)):
                fleet.add_node(f"s{s}-h{h}", labels={SLICE_KEY: f"slice-{s}"})
        policy = self._remediation_policy(rng)
        self._drive_to_lkg(cluster, inner, fleet, policy, rng, crashing=cluster)
        illegal = [
            t
            for t in observed_transitions(inner)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"seed {seed}: illegal transitions {illegal}"

    def test_bad_revision_at_512_nodes_trips_and_rolls_back(self):
        """The acceptance scenario: an injected bad revision on a
        512-node slice-aware fleet trips the breaker and returns every
        upgraded node to the LKG revision without violating the
        maxUnavailable slice budget."""
        from k8s_operator_libs_tpu_torch.api import RemediationSpec

        rng = random.Random(13_000)
        cluster = InMemoryCluster()
        fleet = Fleet(cluster)
        for s in range(128):
            for h in range(4):
                fleet.add_node(
                    f"s{s:03d}-h{h}", labels={SLICE_KEY: f"sl-{s:03d}"}
                )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("25%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            remediation=RemediationSpec(
                failure_threshold=0.25,
                min_attempted=8,
                auto_rollback=True,
                max_node_attempts=10,
                backoff_seconds=0.0,
            ),
        )
        self._drive_to_lkg(cluster, cluster, fleet, policy, rng, cycles=400)
        from k8s_operator_libs_tpu_torch import metrics

        assert metrics.default_registry().counter(
            "remediation_breaker_trips_total",
            "Failure-budget circuit breaker trips.",
        ).value() >= 1
        assert metrics.default_registry().counter(
            "rollbacks_total",
            "Automatic last-known-good DaemonSet rollbacks initiated.",
        ).value() >= 1
        illegal = [
            t
            for t in observed_transitions(cluster)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"illegal transitions {illegal}"

    def test_quarantine_routes_wave_around_chronic_failure(self):
        """A node that fails on EVERY revision exhausts its retry budget,
        is quarantined (annotation + NoSchedule taint), and the rest of
        the fleet still converges to the LKG — the wave routes around
        the chronic failure instead of retrying forever."""
        from k8s_operator_libs_tpu_torch.api import RemediationSpec

        cluster = InMemoryCluster()
        fleet = Fleet(cluster)
        for h in range(2):
            fleet.add_node(f"s0-h{h}", labels={SLICE_KEY: "s0"})
            fleet.add_node(f"s1-h{h}", labels={SLICE_KEY: "s1"})
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            # 100%: a quarantined node still holds unavailability budget
            # (its capacity is genuinely down — docs/automatic-upgrade.md);
            # a tighter budget would wedge on the chronic node by design
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            remediation=RemediationSpec(
                failure_threshold=0.9,  # high: the breaker must NOT trip
                min_attempted=50,
                auto_rollback=False,
                max_node_attempts=2,
                backoff_seconds=0.0,
            ),
        )
        manager = make_manager(cluster)
        for _ in range(3):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()

        # rev2 is healthy fleet-wide, but s0-h0's replacement pods are
        # broken by hand every cycle — a chronic single-node failure
        fleet.publish_new_revision("rev2")
        quarantine_key = util.get_quarantine_annotation_key()

        def break_node_pod() -> None:
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                if (
                    pod["spec"].get("nodeName") == "s0-h0"
                    and pod["metadata"]["labels"][
                        "controller-revision-hash"
                    ]
                    == "rev2"
                ):
                    pod["status"]["containerStatuses"] = [
                        {"name": "driver", "ready": False, "restartCount": 11}
                    ]
                    cluster.update(pod)

        state_key = util.get_upgrade_state_label_key()
        for _ in range(100):
            break_node_pod()
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            node = cluster.get("Node", "s0-h0")
            quarantined = (
                (node["metadata"].get("annotations") or {})
                .get(quarantine_key, "")
                .startswith(consts.REMEDIATION_QUARANTINE_PREFIX)
            )
            others_done = all(
                (n["metadata"].get("labels") or {}).get(state_key)
                == consts.UPGRADE_STATE_DONE
                for n in cluster.list("Node")
                if n["metadata"]["name"] not in ("s0-h0", "s0-h1")
            )
            if quarantined and others_done:
                break
        else:
            pytest.fail(
                f"quarantine/convergence not reached: {fleet.states()}"
            )
        node = cluster.get("Node", "s0-h0")
        taints = (node.get("spec") or {}).get("taints") or []
        assert any(
            t.get("key") == util.get_quarantine_taint_key() for t in taints
        ), f"quarantine taint missing: {taints}"
        attempts = (node["metadata"].get("annotations") or {}).get(
            util.get_attempt_count_annotation_key()
        )
        assert attempts is not None and int(attempts) >= 2


class TestPaginatedPathChaos:
    """Chaos on the chunked-LIST path over real HTTP.

    Two production failure modes the reference inherits from client-go's
    pager + reflector (go.mod:11-16) and this library must absorb:

    * apiserver compaction expiring a continue token MID-pagination
      while a rollout is in flight — the pager's 410 → full-relist
      fallback (kubeclient.list attempt loop) on the hot path;
    * a held watch stream abruptly reset mid-hold while the informer is
      reseeding through a PAGED relist — reconnect with a stale
      position, 410, kind-state drop, paged reseed, all concurrent
      with manager writes.

    Both specs assert CONVERGENCE plus proof the failure path actually
    fired (metrics counters / facade fault counters) — a chaos test
    that cannot show the chaos happened proves nothing.
    """

    def _policy(self):
        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )

    @staticmethod
    def _roll_journal(store, state, n):
        """Append *n* journal entries (Event creates) so the retention
        floor advances past any open LIST snapshot / watch position —
        the compaction analog, driven through the REAL write path."""
        for _ in range(n):
            state["chaos_writes"] = state.get("chaos_writes", 0) + 1
            store.create(
                {
                    "kind": "Event",
                    "metadata": {
                        "name": f"chaos-{state['chaos_writes']}",
                        "namespace": NAMESPACE,
                    },
                    "reason": "ChaosChurn",
                }
            )

    def test_continue_token_410_mid_rollout_converges(self):
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.cluster import (
            ApiServerFacade,
            KubeApiClient,
            KubeConfig,
        )

        restarts = metrics.default_registry().counter(
            "list_pagination_restarts_total",
            "Chunked-LIST restarts after a continue token expired (410).",
        )
        before = restarts.value()

        store = InMemoryCluster()
        store._journal_cap = 60  # tight retention: churn compacts fast
        state = {"continues": 0, "fires": 0}

        def expire_snapshots_hook(method, info, namespace, name, query):
            # Sabotage every 7th continue request (max 3): enough churn
            # lands between the first page and this one that the
            # server's OWN retention check 410s the token.  Spacing 7
            # guarantees the pager's one restart attempt (its continue
            # requests arrive immediately after) always survives.
            if method != "get" or "continue" not in query:
                return
            state["continues"] += 1
            if state["fires"] < 3 and state["continues"] % 7 == 1:
                state["fires"] += 1
                self._roll_journal(store, state, 80)

        facade = (
            ApiServerFacade(store, max_list_page=3)
            .with_faults(request_hook=expire_snapshots_hook)
            .start()
        )
        try:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            fleet = Fleet(client)
            for i in range(8):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            manager = ClusterUpgradeStateManager(
                client,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            policy = self._policy()
            for _ in range(30):
                s = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(s, policy)
                manager.drain_manager.wait_idle(10)
                manager.pod_manager.wait_idle(10)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
        finally:
            facade.stop()
        # The chaos demonstrably happened: tokens were expired and the
        # pager took its full-relist fallback at least once.
        assert state["fires"] >= 1, "chaos hook never armed"
        assert restarts.value() - before >= 1, (
            "no pagination restart recorded — the 410-on-continue path "
            "was not exercised"
        )

    def test_held_stream_flap_during_paged_reseed_converges(self):
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.cluster import (
            ApiServerFacade,
            KubeApiClient,
            KubeConfig,
        )

        reconnects = metrics.default_registry().counter(
            "watch_stream_reconnects_total",
            "Held watch stream reconnects, by kind.",
            ("kind",),
        )
        before = sum(
            reconnects.value(k) for k in ("Node", "Pod", "DaemonSet")
        )

        store = InMemoryCluster()
        store._journal_cap = 60
        state = {"requests": 0}

        def churn_hook(method, info, namespace, name, query):
            # Every 40th request: a churn burst that rolls the journal
            # past the retention floor, so flapped streams reconnecting
            # with their old positions hit 410 and the informer must
            # reseed through a PAGED relist (max_list_page=3).
            state["requests"] += 1
            if state["requests"] % 40 == 0:
                self._roll_journal(store, state, 80)

        facade = (
            ApiServerFacade(store, max_list_page=3)
            .with_faults(request_hook=churn_hook, held_stream_max_frames=4)
            .start()
        )
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        try:
            fleet = Fleet(client)
            for i in range(8):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            client.start_held_watches(("Node", "Pod", "DaemonSet"))
            cache = InformerCache(
                client,
                lag_seconds=0.02,
                kinds=("Node", "Pod", "DaemonSet", "ControllerRevision"),
            )
            manager = ClusterUpgradeStateManager(
                client,
                cache=cache,
                reads_from_cache=True,
                cache_sync_timeout_seconds=5.0,
                cache_sync_poll_seconds=0.01,
            )
            policy = self._policy()
            for _ in range(40):
                s = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(s, policy)
                manager.drain_manager.wait_idle(10)
                manager.pod_manager.wait_idle(10)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            # A loaded machine can converge the 8-node rollout before
            # any held stream has delivered max_frames — keep the
            # journal moving (bounded) until a flap demonstrably
            # happened and a stream came back, so the assertions below
            # test the recovery path, not thread-scheduling luck.
            deadline = time.monotonic() + 15.0
            while (
                facade.fault_counters["held_flaps"] < 1
                or sum(
                    reconnects.value(k)
                    for k in ("Node", "Pod", "DaemonSet")
                )
                - before
                < 1
            ) and time.monotonic() < deadline:
                # frames must be OF a held kind to count against
                # max_frames — annotate a node rather than churn Events
                for _ in range(6):
                    state["chaos_writes"] = state.get("chaos_writes", 0) + 1
                    store.patch(
                        "Node",
                        "n0",
                        {
                            "metadata": {
                                "annotations": {
                                    "chaos-tick": str(state["chaos_writes"])
                                }
                            }
                        },
                    )
                time.sleep(0.2)
        finally:
            try:
                client.stop_held_watches()
            except Exception:  # noqa: BLE001 — teardown
                pass
            facade.stop()
        assert facade.fault_counters["held_flaps"] >= 1, (
            "no held stream was ever reset — flap knob inert"
        )
        after = sum(
            reconnects.value(k) for k in ("Node", "Pod", "DaemonSet")
        )
        assert after - before >= 1, (
            "no watch re-establishment recorded after flaps"
        )


class TestJournalStormUnderPaginatedRelist:
    """Journal-retention 410 storms under paginated
    relist.  The state index's auto full-rebuild path (410 on its
    events_since cursor → rebuild("journal-expired") through the
    server-paginated LIST) must absorb REPEATED storms mid-wave — the
    previous coverage was a single expire_snapshots_hook case on the
    pager alone, with no state index in the loop."""

    def test_repeated_storms_rebuild_index_mid_wave_and_converge(self):
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.cluster import (
            ApiServerFacade,
            KubeApiClient,
            KubeConfig,
        )

        rebuilds = metrics.default_registry().counter(
            "state_index_rebuilds_total",
            "Full ClusterStateIndex resyncs, by reason "
            "(seed | journal-expired | relist).",
            ("reason",),
        )
        before = rebuilds.value("journal-expired")

        store = InMemoryCluster()
        store._journal_cap = 60  # tight retention: churn compacts fast
        state = {"writes": 0, "storms": 0}

        def roll_journal() -> None:
            # push the retention floor past every open journal cursor
            # (the index's, the fleet informer's) in one burst
            for _ in range(80):
                state["writes"] += 1
                store.create(
                    {
                        "kind": "Event",
                        "metadata": {
                            "name": f"storm-{state['writes']}",
                            "namespace": NAMESPACE,
                        },
                        "reason": "ChaosChurn",
                    }
                )
            state["storms"] += 1

        facade = ApiServerFacade(store, max_list_page=3).start()
        manager = None
        try:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            fleet = Fleet(client)
            for i in range(8):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            manager = ClusterUpgradeStateManager(
                client,
                use_state_index=True,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            # one node at a time stretches the wave so multiple storms
            # land strictly MID-rollout, not after convergence
            policy = UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                max_unavailable=IntOrString(1),
                drain_spec=DrainSpec(
                    enable=True, force=True, timeout_second=10
                ),
            )
            converged = False
            for cycle in range(80):
                if cycle and cycle % 2 == 0:
                    roll_journal()
                s = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(s, policy)
                manager.drain_manager.wait_idle(10)
                manager.pod_manager.wait_idle(10)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    converged = True
                    break
            assert converged, f"storms wedged the rollout: {fleet.states()}"
        finally:
            if manager is not None:
                manager.shutdown()
            facade.stop()
        # the chaos demonstrably happened — repeatedly — and the index
        # took its journal-expired full rebuild each time instead of
        # silently serving stale assemblies or falling over
        assert state["storms"] >= 3, "journal never stormed mid-wave"
        assert rebuilds.value("journal-expired") - before >= 3, (
            "the state index's auto full-rebuild path was not exercised "
            "repeatedly (journal-expired rebuilds "
            f"{rebuilds.value('journal-expired') - before})"
        )

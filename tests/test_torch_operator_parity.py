"""The port's operator against the JAX package's, in lockstep.

Each case builds the same seeded fleet in both packages: the JAX one on
``tests/harness.Fleet`` over its ``InMemoryCluster``, the port's on
``tests/test_torch_harness.Fleet`` over the port's.  Each package applies
its own policy CRD with its own ``crdutil`` (the JAX file from
``hack/crd/bases``, the port's from ``k8s_operator_libs_tpu_torch/crd``),
creates the policy CR of that CRD, and assembles its operator with
``new_upgrade_controller(..., policy_source=CrPolicySource(...))``.

The two controllers are stepped in lockstep, one reconcile each, by
calling each reconciler directly (no worker threads), at one pinned
clock.  After every reconcile the clusters (uid and creation time
masked), the decision logs, the recorded events and the reconcilers'
``Result`` (requeue, delay, trigger) must be equal after
:func:`test_torch_vocab.to_port_vocab`.  Mid-rollout the policy CR is
edited in both, then deleted in both, which pauses both rollouts, as
``tests/test_controller.py::TestCrDrivenPolicy::test_cr_deleted_mid_rollout_pauses``
does on one package.
"""

import dataclasses
import json
import random
from pathlib import Path

import pytest

import harness as jharness
import test_torch_harness as pharness
from k8s_operator_libs_tpu import controller as jcontroller
from k8s_operator_libs_tpu import crdutil as jcrdutil
from k8s_operator_libs_tpu_torch import controller, crdutil
from test_torch_rollout_parity import (  # noqa: F401
    JAX,
    PASS_SECONDS,
    PORT,
    EPOCH,
    _decisions,
    _masked,
    _recorded,
    pinned_clock,
)
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

ROOT = Path(__file__).resolve().parent.parent
CRD_FILES = {
    "jax": ROOT / "hack" / "crd" / "bases" / "tpu.google.com_tpuupgradepolicies.yaml",
    "port": ROOT / "k8s_operator_libs_tpu_torch" / "crd" / "nvidia.com_gpuupgradepolicies.yaml",
}
POLICY_NAME = "fleet-policy"


def policy_spec(rng: random.Random) -> dict:
    """The CR's spec (camelCase, as a user writes it): slice-aware, a
    seeded parallel budget and unavailability, drain forced."""
    return {
        "autoUpgrade": True,
        "maxParallelUpgrades": rng.choice([0, 1, 2, 3]),
        "maxUnavailable": rng.choice(["25%", "50%", "100%", 2]),
        "sliceAware": rng.random() < 0.5,
        "drain": {"enable": True, "force": True, "timeoutSeconds": 30},
    }


class Side:
    """One package's operator: its cluster with the policy CRD and CR,
    its harness fleet, its state machine and its controller."""

    def __init__(self, which: str, seed: int):
        pkg, harness = (JAX, jharness) if which == "jax" else (PORT, pharness)
        ctl, crd = (jcontroller, jcrdutil) if which == "jax" else (controller, crdutil)
        rng = random.Random(seed)
        self.pkg, self.harness, self.ctl = pkg, harness, ctl
        self.cluster = pkg.cluster_cls()
        applied = crd.process_crds(self.cluster, crd.OPERATION_APPLY, str(CRD_FILES[which]))
        assert [c["spec"]["names"]["kind"] for c in applied] == [ctl.POLICY_KIND]
        self.fleet = harness.Fleet(self.cluster, revision_hash="rev1")
        racks = rng.randint(2, 4)
        for rack in range(racks):
            for host in range(rng.randint(2, 4)):
                in_sync = rng.random() < 0.15
                self.fleet.add_node(
                    f"rack{rack}-host{host}", pod_hash="rev2" if in_sync else None,
                    labels={pkg.consts.SLICE_ID_LABEL_KEYS[0]: f"rack-{rack}"},
                )
        self.fleet.publish_new_revision("rev2")
        spec = policy_spec(rng)
        self.cluster.create({
            "apiVersion": f"{applied[0]['spec']['group']}/v1alpha1",
            "kind": ctl.POLICY_KIND,
            "metadata": {"name": POLICY_NAME, "namespace": harness.NAMESPACE},
            "spec": to_port_vocab(spec) if which == "port" else spec,
        })
        self.manager = pkg.state.ClusterUpgradeStateManager(
            self.cluster, recorder=pkg.util.EventRecorder(), cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01, flight_recorder=pkg.timeline.FlightRecorder())
        self.controller = ctl.new_upgrade_controller(
            self.cluster, self.manager, harness.NAMESPACE, harness.DRIVER_LABELS,
            policy_source=ctl.CrPolicySource(self.cluster, POLICY_NAME, harness.NAMESPACE))

    def reconcile(self):
        """One reconcile of the controller's reconciler, its async drains
        and evictions awaited, then the harness's DaemonSet controller."""
        result = self.controller._reconciler.reconcile(self.ctl.UPGRADE_REQUEST)
        assert self.manager.drain_manager.wait_idle(30.0) and self.manager.pod_manager.wait_idle(30.0)
        self.fleet.reconcile_daemonset()
        return None if result is None else dataclasses.asdict(result)

    def states(self):
        return self.fleet.states()

    def close(self):
        self.controller.stop()
        self.manager.shutdown()


@pytest.fixture()
def sides(request, pinned_clock):
    seed = request.param
    pinned_clock(EPOCH)
    made = [Side("jax", seed), Side("port", seed)]
    yield made
    for side in made:
        side.close()


def _stable(cluster):
    """The masked cluster in the port's vocabulary, without
    resourceVersions (the drain and eviction workers write in no fixed
    order), ordered after the rewrite (the policy kinds sort apart)."""
    objects = to_port_vocab(_masked(cluster))
    for obj in objects:
        obj["metadata"].pop("resourceVersion", None)
    return sorted(objects, key=lambda o: (o["kind"], o["metadata"].get("namespace", ""), o["metadata"]["name"]))


def step(pin, jside, pside, n: int):
    """Reconcile #n on both sides at the same pinned instant; everything
    the two operators wrote and returned must agree."""
    pin(EPOCH + n * PASS_SECONDS)
    results = (jside.reconcile(), pside.reconcile())
    assert _stable(jside.cluster) == _stable(pside.cluster), f"reconcile {n}: the clusters differ"
    assert sorted(to_port_vocab(_decisions(JAX)), key=json.dumps) == sorted(
        _decisions(PORT), key=json.dumps), f"reconcile {n}: the decision logs differ"
    assert sorted(to_port_vocab(_recorded(jside.manager))) == sorted(_recorded(pside.manager)), (
        f"reconcile {n}: the recorded events differ")
    assert results[0] == results[1], f"reconcile {n}: the results differ"
    return results[1]


def _done(side):
    return sum(1 for s in side.states().values() if s == PORT.consts.UPGRADE_STATE_DONE)


SEEDS = range(4)


@pytest.mark.parametrize("sides", SEEDS, indirect=True, ids=lambda s: f"seed{s}")
def test_the_operators_agree_reconcile_by_reconcile(sides, pinned_clock):
    jside, pside = sides
    nodes = len(pside.states())
    results = []
    for n in range(40):
        results.append(step(pinned_clock, jside, pside, n))
        if _done(pside) == nodes:
            break
    assert _done(pside) == nodes, pside.states()
    assert all(r is not None and r["requeue_after"] > 0 for r in results)
    assert step(pinned_clock, jside, pside, n + 1) is None  # a finished rollout goes quiet


@pytest.mark.parametrize("sides", SEEDS, indirect=True, ids=lambda s: f"seed{s}")
def test_a_cr_edit_and_delete_mid_rollout_agree(sides, pinned_clock):
    """One node at a time until the first is done; then the CR is edited
    (two at a time, all unavailable allowed) and the operators go on
    alike; then the CR is deleted and both rollouts pause where they
    stand: no reconcile moves a node, and every result is None."""
    jside, pside = sides
    serial = {"spec": {"maxParallelUpgrades": 1, "maxUnavailable": 1}}
    for side in sides:
        side.cluster.patch(side.ctl.POLICY_KIND, POLICY_NAME, serial, side.harness.NAMESPACE)
    n = 0
    while _done(pside) == 0:
        step(pinned_clock, jside, pside, n)
        n += 1
        assert n < 20, pside.states()
    widen = {"spec": {"maxParallelUpgrades": 2, "maxUnavailable": "100%"}}
    for side in sides:
        side.cluster.patch(side.ctl.POLICY_KIND, POLICY_NAME, widen, side.harness.NAMESPACE)
    for _ in range(2):
        step(pinned_clock, jside, pside, n)
        n += 1
    for side in sides:
        assert side.controller._reconciler.policy_source.current().max_parallel_upgrades == 2
        side.cluster.delete(side.ctl.POLICY_KIND, POLICY_NAME, side.harness.NAMESPACE)
    # the first paused pass may still finish work in flight; then nothing moves
    step(pinned_clock, jside, pside, n)
    paused = pside.states()
    for k in range(1, 4):
        assert step(pinned_clock, jside, pside, n + k) is None
        assert pside.states() == paused
    # paused mid-rollout: some nodes done, some never admitted
    assert _done(pside) >= 1
    assert PORT.consts.UPGRADE_STATE_UPGRADE_REQUIRED in paused.values(), paused

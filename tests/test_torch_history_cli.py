"""The classes of ``tests/test_history.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestHistoryCli``, ``TestHistoryReviewRegressions``."""

from __future__ import annotations

import json

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import make_node
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    consts,
    node_event_history,
    render_history,
    util,
)

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


def _rolled_cluster():
    """A fleet rolled to done through a recorder, leaving real Events."""
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for i in range(2):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("v2")
    recorder = util.ClusterEventRecorder(cluster, namespace=NAMESPACE)
    manager = ClusterUpgradeStateManager(
        cluster,
        recorder=recorder,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )
    for _ in range(40):
        state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
        if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
            break
    else:
        raise AssertionError(f"rollout did not converge: {fleet.states()}")
    manager.shutdown()
    return cluster


class TestHistoryCli:
    def test_history_from_state_file(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster = _rolled_cluster()
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(["history", "--state-file", str(path)])
        out = capsys.readouterr().out
        assert rc == 0
        assert "n0" in out and "LAST SEEN" in out

        rc = cli_main(
            ["history", "--state-file", str(path), "--node", "n1", "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data and all(e["node"] == "n1" for e in data)

    def test_history_live_over_http(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        cluster = _rolled_cluster()
        with ApiServerFacade(cluster) as facade:
            kubeconfig = tmp_path / "kubeconfig"
            kubeconfig.write_text(
                "\n".join(
                    [
                        "apiVersion: v1",
                        "kind: Config",
                        "current-context: test",
                        "contexts:",
                        "- name: test",
                        "  context: {cluster: test, user: test}",
                        "clusters:",
                        "- name: test",
                        f"  cluster: {{server: {facade.url}}}",
                        "users:",
                        "- name: test",
                        "  user: {token: dummy}",
                    ]
                )
            )
            rc = cli_main(
                ["history", "--kubeconfig", str(kubeconfig), "--json"]
            )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert {"n0", "n1"} <= {e["node"] for e in data}


class TestHistoryReviewRegressions:
    def test_malformed_count_does_not_traceback(self, tmp_path, capsys):
        """A hand-edited dump with a non-numeric Event count renders with
        the default count instead of a ValueError traceback."""
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster = _rolled_cluster()
        dump = cluster.to_dict()
        for obj in dump["objects"]:
            if obj.get("kind") == "Event":
                obj["count"] = "2x"
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(dump))
        rc = cli_main(["history", "--state-file", str(path)])
        out = capsys.readouterr().out
        assert rc == 0
        assert "n0" in out

    def test_live_read_failure_exits_2_not_empty(self, capsys):
        """An apiserver error on the Events read must exit 2, never print
        'No node upgrade events found.' with rc=0 (the
        explicit-namespace path swallowed every ApiError)."""
        from k8s_operator_libs_tpu_torch.cluster.errors import UnauthorizedError
        from k8s_operator_libs_tpu_torch.upgrade.history import node_event_history

        class Denied:
            def list(self, *a, **kw):
                raise UnauthorizedError("token expired")

        import pytest as _pytest

        with _pytest.raises(UnauthorizedError):
            node_event_history(Denied(), namespaces=["tpu-ops"])

    def test_history_rejects_fleet_query_flags(self, tmp_path, capsys):
        """history reads raw Events; the fleet-coordinate flags
        (--component/--selector) belong to status/plan only and must be
        rejected, not silently ignored."""
        import pytest as _pytest

        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster = _rolled_cluster()
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        with _pytest.raises(SystemExit):
            cli_main(
                [
                    "history",
                    "--state-file",
                    str(path),
                    "--component",
                    "gpu-driver",
                ]
            )

    def test_server_side_field_selector_used_when_supported(self):
        """Live path: Events are filtered server-side via the
        involvedObject fieldSelector; unsupported backends fall back."""
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError
        from k8s_operator_libs_tpu_torch.upgrade.history import node_event_history

        calls = []

        class Recording:
            def list(self, kind, namespace=None, field_selector="", **kw):
                calls.append(field_selector)
                if field_selector:
                    raise BadRequestError("unsupported")
                return []

        node_event_history(Recording(), node="n1")
        assert calls[0] == "involvedObject.kind=Node,involvedObject.name=n1"
        assert calls[1] == ""  # fallback ran

    def test_component_filter_drops_kubelet_noise(self):
        """Real clusters fill Node events with kubelet/node-controller
        noise; --source keeps the operator's upgrade timeline only."""
        cluster = _rolled_cluster()
        # a kubelet-style event about the same node
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "n0.kubelet1", "namespace": "default"},
                "involvedObject": {"kind": "Node", "name": "n0"},
                "reason": "NodeHasSufficientMemory",
                "message": "Node n0 status is now: NodeHasSufficientMemory",
                "type": "Normal",
                "source": {"component": "kubelet"},
                "count": 1,
                "firstTimestamp": "2026-01-01T00:00:00Z",
                "lastTimestamp": "2026-01-01T00:00:00Z",
            }
        )
        from k8s_operator_libs_tpu_torch.upgrade.history import node_event_history
        from k8s_operator_libs_tpu_torch.upgrade.util import get_event_reason

        unfiltered = node_event_history(cluster)
        assert any(e.component == "kubelet" for e in unfiltered)
        filtered = node_event_history(cluster, component=get_event_reason())
        assert filtered
        assert all(e.component == get_event_reason() for e in filtered)

    def test_offline_dump_with_no_events_renders_empty(self, tmp_path, capsys):
        """A dump captured before any rollout has zero Events: the CLI
        must print the empty-table sentinel (and [] with --json), rc 0."""
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster = InMemoryCluster()
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(["history", "--state-file", str(path)])
        assert rc == 0
        assert "No node upgrade events found." in capsys.readouterr().out
        rc = cli_main(["history", "--state-file", str(path), "--json"])
        assert rc == 0
        assert json.loads(capsys.readouterr().out) == []

    def test_offline_dump_missing_count_and_timestamps(self):
        """Hand-pruned dumps (or events.k8s.io writers) may omit count
        and every timestamp; entries default (count=1, empty stamps sort
        first) instead of tracebacking."""
        cluster = InMemoryCluster()
        cluster.create(make_node("n9"))
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "n9.bare", "namespace": "default"},
                "involvedObject": {"kind": "Node", "name": "n9"},
                "reason": "Sparse",
                "message": "no count, no timestamps",
                "type": "Normal",
            }
        )
        entries = node_event_history(cluster, node="n9")
        assert len(entries) == 1
        entry = entries[0]
        assert entry.count == 1
        assert entry.first_timestamp == "" and entry.last_timestamp == ""
        text = render_history(entries)
        assert "Sparse" in text and "n9" in text

    def test_unknown_node_filter_raises_not_found(self, tmp_path, capsys):
        """--node naming a node the dump has never heard of must be a
        NotFoundError (CLI exit 3), never a clean empty timeline — a
        typo'd node name reading as 'all done' is how stuck rollouts
        hide."""
        import pytest as _pytest

        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
        from k8s_operator_libs_tpu_torch.cluster.errors import NotFoundError

        cluster = _rolled_cluster()
        with _pytest.raises(NotFoundError):
            node_event_history(cluster, node="no-such-node")
        # a node that EXISTS but has no events is a real empty answer
        cluster.create(make_node("quiet-node"))
        assert node_event_history(cluster, node="quiet-node") == []
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            ["history", "--state-file", str(path), "--node", "no-such-node"]
        )
        assert rc == 3
        assert "not found" in capsys.readouterr().err

    def test_event_time_fallback_for_new_style_events(self):
        """events.k8s.io writers fill eventTime and leave the legacy
        timestamps null — such events must sort and render, not collapse
        to a blank first slot."""
        cluster = _rolled_cluster()
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "n0.newstyle", "namespace": "default"},
                "involvedObject": {"kind": "Node", "name": "n0"},
                "reason": "Modern",
                "message": "events.k8s.io-style",
                "type": "Normal",
                "reportingController": "third-party.io/controller",
                "eventTime": "2099-01-01T00:00:00Z",
            }
        )
        from k8s_operator_libs_tpu_torch.upgrade.history import node_event_history

        entries = node_event_history(cluster)
        modern = [e for e in entries if e.reason == "Modern"]
        assert modern and modern[0].last_timestamp == "2099-01-01T00:00:00Z"
        # reportingController fallback (deprecated source block absent)
        assert modern[0].component == "third-party.io/controller"
        assert entries[-1].reason == "Modern"  # future stamp sorts last

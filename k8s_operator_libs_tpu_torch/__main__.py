"""Command-line entry point: ``python -m k8s_operator_libs_tpu_torch``.

Subcommands:

* ``status`` — compute and print the rollout status
  (:mod:`.upgrade.rollout_status`) from a persisted cluster dump (the
  ``--state-file`` JSON the example CLIs write, see
  ``examples/apply_crds.py``) or live via ``--kubeconfig``/
  ``--in-cluster``.  The reference has no equivalent; consumers grep
  node labels by hand.

      python -m k8s_operator_libs_tpu_torch status --state-file /tmp/cluster.json \\
          --namespace tpu-ops --selector app=gpu-driver --component gpu-driver
      python -m k8s_operator_libs_tpu_torch status --state-file ... --json

* ``plan`` — dry-run the rollout (:mod:`.upgrade.plan`): simulate the
  next reconcile cycles on a sandbox clone and print which nodes would
  be admitted, every projected transition, and the admission gates —
  without writing anything to the source.

      python -m k8s_operator_libs_tpu_torch plan --state-file /tmp/cluster.json \\
          --policy fleet-policy --cycles 5
      python -m k8s_operator_libs_tpu_torch plan --kubeconfig --policy fleet-policy

* ``traces`` — pretty-print (or re-export) a reconcile trace dump saved
  from the operator's ``GET /debug/traces`` endpoint (any of the three
  formats it serves), or run the tracing pipeline selftest.

      curl $OPS/debug/traces > traces.json
      python -m k8s_operator_libs_tpu_torch traces --file traces.json
      python -m k8s_operator_libs_tpu_torch traces --file traces.json --fmt chrome
      python -m k8s_operator_libs_tpu_torch traces --selftest

* ``explain`` / ``events`` — the decision-audit plane
  (:mod:`.obs.events`): "why is node X not progressing" with a
  machine-readable reason code, and the reason-coded decision stream
  reconstructed from the persisted Event objects.

      python -m k8s_operator_libs_tpu_torch explain --state-file dump.json --node n17
      python -m k8s_operator_libs_tpu_torch events --kubeconfig --json
      python -m k8s_operator_libs_tpu_torch explain --selftest   # make verify-events

* ``pacing`` — the analysis-gate/adaptive-pacing plane
  (:mod:`.upgrade.analysis`): the active analysis step, its
  advance/abort condition values, exposure cap and AIMD wave scale,
  and the closed-loop selftest.

      python -m k8s_operator_libs_tpu_torch pacing --state-file dump.json --policy p
      python -m k8s_operator_libs_tpu_torch pacing --selftest   # make verify-pacing

* ``chaos`` — the chaos campaign engine (:mod:`.upgrade.chaos`):
  declarative fault-scenario sweeps crossed with config axes, every
  cell checked by the rollout-invariant checker against the decision
  stream; prints the resilience scorecard.

      python -m k8s_operator_libs_tpu_torch chaos --list
      python -m k8s_operator_libs_tpu_torch chaos --seed 7 --json
      python -m k8s_operator_libs_tpu_torch chaos --scenario apiserver-brownout
      python -m k8s_operator_libs_tpu_torch chaos --campaign nightly.json
      python -m k8s_operator_libs_tpu_torch chaos --selftest   # make verify-chaos

* ``fedstatus`` — the fleet-of-fleets federation plane
  (:mod:`.federation`): cell phases (canary cluster → region → global),
  the global breaker, the ETA rollup, "why is cell Y not promoting",
  and the merged cross-cluster audit trail.

      python -m k8s_operator_libs_tpu_torch fedstatus --url http://127.0.0.1:8080
      python -m k8s_operator_libs_tpu_torch fedstatus --spec fed.json \\
          --cell canary=a.json --cell region=b.json --explain region
      python -m k8s_operator_libs_tpu_torch fedstatus --selftest   # make verify-federation

* ``profile`` — the continuous profiling plane (:mod:`.obs.profiling`):
  live-capture a window from the operator's ``/debug/profile``
  endpoint, render a saved dump (span self-time table + top frames,
  collapsed stacks, or speedscope JSON), and diff two dumps for the
  top regressing frames.

      python -m k8s_operator_libs_tpu_torch profile --url http://op:8080 --seconds 5
      python -m k8s_operator_libs_tpu_torch profile --file profile.json --fmt collapsed
      python -m k8s_operator_libs_tpu_torch profile diff before.txt after.txt
      python -m k8s_operator_libs_tpu_torch profile --selftest   # make verify-profile
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Tuple

from .cluster.inmem import InMemoryCluster
from .upgrade import util
from .upgrade.rollout_status import RolloutStatus
from .upgrade.upgrade_state import ClusterUpgradeStateManager


def _positive_float(raw: str) -> float:
    value = float(raw)
    if value <= 0:
        raise argparse.ArgumentTypeError(
            f"must be > 0 (a 0 interval busy-spins the apiserver), got {raw}"
        )
    return value


def _parse_selector_arg(selector: str) -> dict:
    labels = {}
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(f"invalid selector term {part!r} (want key=value)")
        k, v = part.split("=", 1)
        labels[k] = v
    return labels


def _open_source(args: argparse.Namespace, cmd: str) -> Tuple[Optional[object], int]:
    """Resolve the ONE cluster source (--state-file | --kubeconfig |
    --in-cluster) shared by the read-only subcommands.  Returns
    (cluster, 0) or (None, exit_code)."""
    if (args.kubeconfig is not None or args.in_cluster) and args.state_file:
        print(
            f"{cmd} takes ONE source: --state-file or "
            "--kubeconfig/--in-cluster, not both",
            file=sys.stderr,
        )
        return None, 2
    if args.kubeconfig is not None or args.in_cluster:
        # Live mode: read through KubeApiClient (same client surface as
        # the operator).
        from .cluster import KubeApiClient, KubeConfig, KubeConfigError

        try:
            if args.in_cluster:
                return KubeApiClient(KubeConfig.in_cluster()), 0
            return (
                KubeApiClient(
                    KubeConfig.load(args.kubeconfig or None, context=args.context)
                ),
                0,
            )
        except KubeConfigError as err:
            print(f"cannot load cluster config: {err}", file=sys.stderr)
            return None, 2
    if args.state_file:
        try:
            with open(args.state_file, "r", encoding="utf-8") as fh:
                return InMemoryCluster.from_dict(json.load(fh)), 0
        except FileNotFoundError:
            print(f"state file not found: {args.state_file}", file=sys.stderr)
            return None, 2
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as err:
            print(
                f"state file {args.state_file} is not a cluster dump: {err}",
                file=sys.stderr,
            )
            return None, 2
    print(
        f"{cmd} needs a source: --state-file DUMP, --kubeconfig "
        "[PATH], or --in-cluster",
        file=sys.stderr,
    )
    return None, 2


def _load_policy_cr(
    args: argparse.Namespace, cluster
) -> "Tuple[Optional[object], int, str]":
    """Load + validate the GpuUpgradePolicy CR named by --policy.
    Returns (policy | None, exit_code, message); a missing CR is
    (None, 0, note) — callers decide whether that is fatal — an invalid
    CR is fatal.  The message is RETURNED, not printed: a watch loop
    re-reads the policy every iteration and must dedup identical
    errors instead of repeating them for hours."""
    if not args.policy:
        return None, 0, ""
    from .api import UpgradePolicySpec, ValidationError
    from .cluster.errors import ApiError, NotFoundError

    try:
        cr = cluster.get("GpuUpgradePolicy", args.policy, args.namespace)
    except NotFoundError:
        return (
            None,
            0,
            f"GpuUpgradePolicy {args.namespace}/{args.policy} not found "
            f"in the source",
        )
    except (ApiError, OSError) as err:
        return (
            None,
            0,
            f"cannot read GpuUpgradePolicy {args.namespace}/"
            f"{args.policy}: {err}",
        )
    try:
        policy = UpgradePolicySpec.from_dict(cr.get("spec") or {})
        policy.validate()
    except ValidationError as err:
        return (
            None,
            2,
            f"GpuUpgradePolicy {args.namespace}/{args.policy} is "
            f"invalid: {err}",
        )
    return policy, 0, ""


def _push_topology_keys(policy) -> None:
    # The domain table and canary census must use the policy's topology
    # keys — same push the live scheduler gets via _configure_from_policy,
    # or status/plan and the scheduler would disagree.
    from .tpu import topology

    topology.set_label_keys(
        policy.slice_label_keys, policy.multislice_label_keys
    )


def cmd_status(args: argparse.Namespace) -> int:
    if args.watch and args.state_file:
        # before _open_source: rejecting after parsing a multi-MB dump
        # wastes the whole read (and repair orders its guard this way)
        print(
            "--watch needs a live source (--kubeconfig/--in-cluster); "
            "a state-file dump never changes",
            file=sys.stderr,
        )
        return 2
    cluster, rc = _open_source(args, "status")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError
    from .obs import slo as slo_mod
    from .upgrade import timeline as timeline_mod
    from .upgrade.upgrade_state import UpgradeStateError

    # Timelines reconstructed from the node-annotation checkpoints feed
    # the ETA / straggler / SLO fragments beside the gates (empty dumps
    # simply render no SLO block).
    recorder = timeline_mod.FlightRecorder()
    slo_engine = slo_mod.SloEngine(recorder)
    manager = ClusterUpgradeStateManager(cluster, flight_recorder=recorder)
    policy = None
    gates_noted = False
    last_policy_msg = None
    last_rendered = None
    while True:
        try:
            state = manager.build_state(
                args.namespace, _parse_selector_arg(args.selector)
            )
        except (ApiError, OSError, UpgradeStateError) as err:
            # Unreachable apiserver / auth failure / 5xx / inconsistent
            # snapshot (unscheduled driver pods) must keep the documented
            # exit-code contract (2 = cannot read the source), not escape
            # as a traceback.  In watch mode a transient error is part of
            # the deal (mid-restart-wave snapshots) — report and keep
            # watching.
            if not args.watch:
                print(f"cannot read cluster state: {err}", file=sys.stderr)
                return 2
            print(
                f"(transient) cannot read cluster state: {err}",
                file=sys.stderr,
            )
            time.sleep(args.interval)
            continue
        # The policy is (re)read EVERY iteration in watch mode: a watch
        # outlives CR edits (the operator honors them live — status must
        # agree) and a transient read failure must not permanently
        # disable gate evaluation; a failed read keeps the last good
        # policy, mirroring CrPolicySource.
        loaded, prc, pmsg = _load_policy_cr(args, cluster)
        if pmsg and pmsg != last_policy_msg:
            print(pmsg, file=sys.stderr)
            last_policy_msg = pmsg
        if prc:
            if not args.watch:
                return prc
        elif loaded is not None:
            policy = loaded
            last_policy_msg = ""
        if args.policy and policy is None and not gates_noted:
            print("gates not evaluated", file=sys.stderr)
            gates_noted = True
        if policy is not None:
            _push_topology_keys(policy)
        # Decision-audit stream (obs/events.py): reconstructed from the
        # persisted Event objects when the operator runs the sink —
        # feeds the last-decisions line and the blocking gate's
        # deferred-node citation.  Optional everywhere: a source without
        # decision Events simply renders the pre-stream status.
        from .obs import events as events_mod

        decisions = events_mod.decisions_from_cluster(cluster)
        status = RolloutStatus.from_cluster_state(
            state,
            policy=policy,
            slo_report=slo_engine.evaluate(state, policy),
            decisions=decisions or None,
        )
        payload = status.to_dict()
        rendered = json.dumps(payload) if args.json else status.render()
        # --watch dedupes on everything except the slo section's
        # VOLATILE numbers: the ETA point estimate and generatedAt move
        # on every evaluation and would print a full status every poll.
        # Breach membership and the straggler set ARE part of the key —
        # a newly wedged node must print immediately, not wait for an
        # unrelated bucket change.
        # ... and likewise the decision stream's counts/timestamps (a
        # gated fleet re-defers every reconcile): only the SET of
        # distinct decisions is part of the key, so a NEW decision
        # prints immediately but a repeat does not.
        # ... and the analysis section's volatile numbers (generatedAt,
        # instantaneous condition values, held-for clocks): only the
        # GATE STATE — active step, abort/pass position, exposure
        # remaining, pacing scale — keys the watch, so a step advance,
        # an abort or a throttle prints immediately but a ticking
        # held-for clock does not.
        slo = payload.get("slo") or {}
        analysis = payload.get("analysis") or {}
        change_key = json.dumps(
            {
                **{
                    k: v
                    for k, v in payload.items()
                    if k not in ("slo", "decisions", "analysis")
                },
                "analysisGate": (
                    {
                        "activeStep": analysis.get("activeStep"),
                        "stepIndex": analysis.get("stepIndex"),
                        "stepStates": [
                            (s.get("name"), s.get("state"))
                            for s in analysis.get("steps") or []
                        ],
                        "aborted": analysis.get("aborted"),
                        "passed": analysis.get("passed"),
                        "suspended": analysis.get("suspended"),
                        "exposureRemaining": (
                            analysis.get("exposure") or {}
                        ).get("remaining"),
                        "scale": (analysis.get("pacing") or {}).get(
                            "scale"
                        ),
                    }
                    if analysis
                    else None
                ),
                "sloBreaches": sorted(
                    b.get("slo", "")
                    for b in (slo.get("slos") or {}).get("breaches") or []
                ),
                "stragglers": sorted(
                    s.get("node", "")
                    for s in slo.get("stragglers") or []
                ),
                "decisions": sorted(
                    f"{d.get('type')}:{d.get('reason')}:{d.get('target')}"
                    for d in payload.get("decisions") or []
                ),
            },
            sort_keys=True,
        )
        if change_key != last_rendered:
            print(rendered, flush=True)
            last_rendered = change_key
        if not args.watch:
            # kubectl-rollout-status convention: nonzero while not
            # complete lets scripts poll until the rollout finishes
            return 0 if status.complete or not args.wait_exit_code else 3
        if status.complete:
            return 0  # kubectl rollout status: block until done, then 0
        time.sleep(args.interval)


def cmd_plan(args: argparse.Namespace) -> int:
    cluster, rc = _open_source(args, "plan")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .api import UpgradePolicySpec
    from .cluster.errors import ApiError
    from .upgrade.plan import plan_rollout
    from .upgrade.upgrade_state import UpgradeStateError

    policy, rc, pmsg = _load_policy_cr(args, cluster)
    if pmsg:
        print(pmsg, file=sys.stderr)
    if rc:
        return rc
    if args.policy and policy is None:
        # Unlike `status` (where a missing policy only skips the gate
        # annotations), the policy determines the ENTIRE projection — a
        # plan for the wrong policy is a wrong blast-radius answer.
        print(
            f"cannot plan: --policy {args.policy} could not be loaded",
            file=sys.stderr,
        )
        return 2
    if policy is None:
        policy = UpgradePolicySpec(auto_upgrade=True)
        print(
            "note: planning with reference-default policy "
            "(maxParallelUpgrades=1, maxUnavailable=25%); pass --policy "
            "to plan a GpuUpgradePolicy CR",
            file=sys.stderr,
        )
    _push_topology_keys(policy)
    try:
        if isinstance(cluster, InMemoryCluster):
            dump = cluster.to_dict()
        else:
            # Live source: one read-only snapshot; the simulation runs
            # entirely on the clone and never writes back.  The sandbox
            # RV counter must start ABOVE every restored object's RV, or
            # sandbox writes would mint resourceVersions that collide
            # with restored ones and defeat conflict detection.
            snap = cluster.snapshot()

            def _rv(obj) -> int:
                try:
                    return int(
                        (obj.get("metadata") or {}).get("resourceVersion")
                        or 0
                    )
                except ValueError:
                    return 0

            objects = list(snap.values())
            dump = {
                "rv": max([0] + [_rv(o) for o in objects]),
                "objects": objects,
            }
        requestor_opts = None
        if args.requestor:
            # Same env contract as the operator (incl. the CR name
            # prefix — an in-flight 'myprefix-<node>' CR must be FOUND,
            # not duplicated), with CLI flags overlaid.
            from .upgrade.upgrade_requestor import get_requestor_opts_from_envs

            requestor_opts = get_requestor_opts_from_envs()
            requestor_opts.use_maintenance_operator = True
            if args.requestor_id:
                requestor_opts.requestor_id = args.requestor_id
            if not requestor_opts.requestor_id:
                requestor_opts.requestor_id = "plan-preview"
            if args.requestor_namespace:
                requestor_opts.requestor_namespace = args.requestor_namespace
        plan = plan_rollout(
            dump,
            args.namespace,
            _parse_selector_arg(args.selector),
            policy,
            cycles=args.cycles,
            requestor_opts=requestor_opts,
            validation_pod_selector=args.validation_selector,
        )
    except (ApiError, OSError, UpgradeStateError) as err:
        print(f"cannot plan from cluster state: {err}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(plan.to_dict()))
    else:
        print(plan.render())
    return 0


def cmd_history(args: argparse.Namespace) -> int:
    cluster, rc = _open_source(args, "history")
    if cluster is None:
        return rc
    from .cluster.errors import ApiError, NotFoundError
    from .upgrade.history import node_event_history, render_history

    try:
        entries = node_event_history(
            cluster,
            node=args.node or None,
            namespaces=(
                [args.events_namespace] if args.events_namespace else None
            ),
            component=args.source or None,
        )
    except NotFoundError:
        # --node names a node the source has never heard of: a typo, not
        # an empty timeline (exit 3 = "queried thing absent", as repair).
        print(f"node {args.node} not found in the source", file=sys.stderr)
        return 3
    except (ApiError, OSError) as err:
        print(f"cannot read events: {err}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps([e.to_dict() for e in entries]))
    else:
        print(render_history(entries))
    return 0


def cmd_traces(args: argparse.Namespace) -> int:
    """Pretty-print / re-export a trace dump, or run the selftest smoke
    (``make verify-obs`` gates on the latter)."""
    from .obs import tracing

    if args.selftest:
        try:
            print(tracing.selftest())
        except AssertionError as err:
            print(f"traces selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    if not args.file:
        print("traces needs --file DUMP (or --selftest)", file=sys.stderr)
        return 2
    try:
        with open(args.file, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
        traces = tracing.traces_from_payload(payload)
    except FileNotFoundError:
        print(f"trace file not found: {args.file}", file=sys.stderr)
        return 2
    except OSError as err:
        # directory / permission denied / IO error — same clean exit as
        # the other subcommands' source-open failures
        print(f"cannot read trace file {args.file}: {err}", file=sys.stderr)
        return 2
    except (json.JSONDecodeError, ValueError, TypeError, KeyError) as err:
        print(f"trace file {args.file} is not a trace dump: {err}", file=sys.stderr)
        return 2
    if args.trace_id:
        traces = [t for t in traces if t.get("trace_id") == args.trace_id]
        if not traces:
            print(f"trace {args.trace_id} not in dump", file=sys.stderr)
            return 3
    if args.fmt == "chrome":
        print(json.dumps(tracing.to_chrome(traces)))
    elif args.fmt == "otlp":
        print(json.dumps(tracing.to_otlp(traces)))
    elif args.json:
        print(json.dumps({"traces": traces}))
    else:
        for i, trace in enumerate(traces):
            if i:
                print()
            print(tracing.render_trace_tree(trace))
    return 0


def cmd_remediation(args: argparse.Namespace) -> int:
    """Inspect the remediation engine: breaker state, last-known-good
    records, per-node retry budgets and quarantines — offline from a
    dump or live.  ``--selftest`` runs the in-memory breaker/rollback
    smoke end-to-end (the ``make verify-remediation`` gate)."""
    if args.selftest:
        from .upgrade import remediation as remediation_mod

        try:
            print(remediation_mod.selftest())
        except AssertionError as err:
            print(f"remediation selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    cluster, rc = _open_source(args, "remediation")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError
    from .upgrade.remediation import remediation_report, render_report
    from .upgrade.upgrade_state import UpgradeStateError

    policy, prc, pmsg = _load_policy_cr(args, cluster)
    if pmsg:
        print(pmsg, file=sys.stderr)
    if prc:
        return prc
    if policy is not None:
        _push_topology_keys(policy)
    manager = ClusterUpgradeStateManager(cluster)
    try:
        state = manager.build_state(
            args.namespace, _parse_selector_arg(args.selector)
        )
    except (ApiError, OSError, UpgradeStateError) as err:
        print(f"cannot read cluster state: {err}", file=sys.stderr)
        return 2
    finally:
        manager.shutdown()
    report = remediation_report(state, policy=policy)
    if args.json:
        print(json.dumps(report))
    else:
        print(render_report(report))
    # poll-friendly: nonzero while the breaker blocks admissions
    return 3 if (report.get("blocking") and args.wait_exit_code) else 0


def cmd_slo(args: argparse.Namespace) -> int:
    """Rollout SLO report: per-phase latency quantiles, fleet ETA with
    confidence band, stragglers, and — when the policy declares an
    ``slos`` block — breach/burn-rate evaluation.  Timelines are
    reconstructed from the flight recorder's node-annotation
    checkpoints, so the offline (``--state-file``) report matches what
    the live operator's ``/debug/slo`` serves.  ``--selftest`` runs the
    end-to-end smoke (the ``make verify-slo`` gate)."""
    if args.selftest:
        from .obs import slo as slo_mod

        try:
            print(slo_mod.selftest())
        except AssertionError as err:
            print(f"slo selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    cluster, rc = _open_source(args, "slo")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError
    from .obs import slo as slo_mod
    from .upgrade import timeline as timeline_mod
    from .upgrade.upgrade_state import UpgradeStateError

    policy, prc, pmsg = _load_policy_cr(args, cluster)
    if pmsg:
        print(pmsg, file=sys.stderr)
    if prc:
        return prc
    if policy is not None:
        _push_topology_keys(policy)
    # A private recorder: build_state's observation sweep reloads every
    # node's annotation checkpoint into it, which IS the offline
    # reconstruction (the same code path the failed-over leader runs).
    recorder = timeline_mod.FlightRecorder()
    manager = ClusterUpgradeStateManager(cluster, flight_recorder=recorder)
    try:
        state = manager.build_state(
            args.namespace, _parse_selector_arg(args.selector)
        )
    except (ApiError, OSError, UpgradeStateError) as err:
        print(f"cannot read cluster state: {err}", file=sys.stderr)
        return 2
    finally:
        manager.shutdown()
    engine = slo_mod.SloEngine(recorder)
    report = engine.evaluate(state, policy)
    if args.json:
        print(json.dumps(report))
    else:
        print(slo_mod.render_report(report))
    breaches = (report.get("slos") or {}).get("breaches") or []
    # poll-friendly: nonzero while a declared SLO is in breach
    return 3 if (breaches and args.wait_exit_code) else 0


def cmd_pacing(args: argparse.Namespace) -> int:
    """Analysis gates + adaptive pacing report: the active step with
    its advance/abort condition values, the exposure cap, and the AIMD
    wave scale — offline from a dump (instantaneous approximation) or
    live (the operator serves the stateful report at
    ``/debug/analysis``).  ``--selftest`` runs the closed-loop smoke
    (the ``make verify-pacing`` gate): healthy soak auto-advances →
    injected burn-rate breach throttles → sustained breach aborts to
    the LKG, verified through the decision stream."""
    if args.selftest:
        from .upgrade import analysis as analysis_mod

        try:
            print(analysis_mod.selftest())
        except AssertionError as err:
            print(f"pacing selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    cluster, rc = _open_source(args, "pacing")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError
    from .obs import slo as slo_mod
    from .upgrade import analysis as analysis_mod
    from .upgrade import timeline as timeline_mod
    from .upgrade.upgrade_state import UpgradeStateError

    policy, prc, pmsg = _load_policy_cr(args, cluster)
    if pmsg:
        print(pmsg, file=sys.stderr)
    if prc:
        return prc
    if policy is None:
        print(
            "pacing needs --policy naming a GpuUpgradePolicy with an "
            "analysis block",
            file=sys.stderr,
        )
        return 2
    if policy.analysis is None:
        print(
            f"GpuUpgradePolicy {args.namespace}/{args.policy} declares "
            "no analysis block",
            file=sys.stderr,
        )
        return 3
    _push_topology_keys(policy)
    recorder = timeline_mod.FlightRecorder()
    manager = ClusterUpgradeStateManager(cluster, flight_recorder=recorder)
    try:
        state = manager.build_state(
            args.namespace, _parse_selector_arg(args.selector)
        )
    except (ApiError, OSError, UpgradeStateError) as err:
        print(f"cannot read cluster state: {err}", file=sys.stderr)
        return 2
    finally:
        manager.shutdown()
    slo_report = slo_mod.SloEngine(recorder).evaluate(state, policy)
    report = analysis_mod.analysis_report(state, policy, slo_report)
    if args.json:
        print(json.dumps(report))
    else:
        print(analysis_mod.render_report(report))
    # poll-friendly: nonzero while an abort condition holds
    pending_abort = bool(report.get("abortPending") or report.get("aborted"))
    return 3 if (pending_abort and args.wait_exit_code) else 0


def _build_explain_inputs(args: argparse.Namespace, cluster):
    """Shared offline/live assembly for ``events``/``explain``: the
    snapshot, the (optional) policy, the checkpoint-reconstructed
    flight recorder, the SLO report, and the decision stream
    reconstructed from persisted Event objects.  Returns
    (state, policy, recorder, slo_report, decisions, exit_code)."""
    from .cluster.errors import ApiError
    from .obs import events as events_mod, slo as slo_mod
    from .upgrade import timeline as timeline_mod
    from .upgrade.upgrade_state import UpgradeStateError

    policy, prc, pmsg = _load_policy_cr(args, cluster)
    if pmsg:
        print(pmsg, file=sys.stderr)
    if prc:
        return None, None, None, None, None, prc
    if policy is not None:
        _push_topology_keys(policy)
    recorder = timeline_mod.FlightRecorder()
    manager = ClusterUpgradeStateManager(cluster, flight_recorder=recorder)
    try:
        state = manager.build_state(
            args.namespace, _parse_selector_arg(args.selector)
        )
    except (ApiError, OSError, UpgradeStateError) as err:
        print(f"cannot read cluster state: {err}", file=sys.stderr)
        return None, None, None, None, None, 2
    finally:
        manager.shutdown()
    slo_report = slo_mod.SloEngine(recorder).evaluate(state, policy)
    decisions = events_mod.decisions_from_cluster(cluster)
    return state, policy, recorder, slo_report, decisions, 0


def cmd_explain(args: argparse.Namespace) -> int:
    """Answer "why is node X not progressing" with a machine-readable
    reason code — offline from a dump (node annotations + persisted
    decision Events reconstruct the verdict) or live.  ``--selftest``
    runs the end-to-end explain smoke (the ``make verify-events``
    gate)."""
    from .obs import events as events_mod

    if args.selftest:
        try:
            print(events_mod.selftest())
        except AssertionError as err:
            print(f"events/explain selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    if not args.node:
        print("explain needs --node NAME (or --selftest)", file=sys.stderr)
        return 2
    cluster, rc = _open_source(args, "explain")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    state, policy, recorder, slo_report, decisions, rc = (
        _build_explain_inputs(args, cluster)
    )
    if rc:
        return rc
    answer = events_mod.explain_node(
        args.node,
        state,
        policy=policy,
        recorder=recorder,
        slo_report=slo_report,
        decisions=decisions,
    )
    if answer is None:
        print(
            f"node {args.node} is not managed by this rollout "
            f"(namespace {args.namespace}, selector {args.selector})",
            file=sys.stderr,
        )
        return 3
    if args.json:
        print(json.dumps(answer))
    else:
        print(events_mod.render_explanation(answer))
    return 0


def cmd_events(args: argparse.Namespace) -> int:
    """List the decision-audit stream from a source's persisted Event
    objects (the live log is served at OpsServer ``/debug/events``).
    ``--selftest`` runs the same end-to-end smoke as ``explain``."""
    from .obs import events as events_mod

    if args.selftest:
        try:
            print(events_mod.selftest())
        except AssertionError as err:
            print(f"events/explain selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    cluster, rc = _open_source(args, "events")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError

    try:
        # strict: an unreachable apiserver must exit 2, not render as
        # "no persisted decision events"
        decisions = events_mod.decisions_from_cluster(cluster, strict=True)
    except (ApiError, OSError) as err:
        print(f"cannot read events: {err}", file=sys.stderr)
        return 2
    if args.node:
        decisions = [d for d in decisions if d.get("target") == args.node]
    if args.type:
        decisions = [d for d in decisions if d.get("type") == args.type]
    if args.json:
        print(json.dumps(decisions))
        return 0
    if not decisions:
        print(
            "no persisted decision events found (is the operator running "
            "the decision-event sink?)"
        )
        return 0
    for d in decisions:
        print(
            f"{d.get('lastTimestamp', '')}  "
            + events_mod.format_decision_line(d)
        )
    return 0


def cmd_fedstatus(args: argparse.Namespace) -> int:
    """Fleet-of-fleets federation status (:mod:`.federation`): cell
    phases, the global breaker, the ETA rollup, the per-cell explain,
    and the merged cross-cluster audit trail — live from a running
    coordinator's ``/debug/federation`` or offline from per-cell dumps
    plus the federation policy.  ``--selftest`` runs the 3-cell
    canary→region→global e2e over real HTTP (the
    ``make verify-federation`` gate)."""
    from .federation import selftest as fed_selftest_mod
    from .federation.coordinator import (
        explain_cell,
        federation_report_from_clusters,
        render_cell_explanation,
        render_federation_report,
    )
    from .obs import events as events_mod

    if args.selftest:
        try:
            print(fed_selftest_mod.selftest())
        except AssertionError as err:
            print(f"federation selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    util.set_component_name(args.component)

    if args.url:
        # live: the coordinator's ops server answers everything
        import urllib.error
        import urllib.request

        base = args.url.rstrip("/") + "/debug/federation"
        if args.explain:
            base += f"?cell={args.explain}"
        elif args.events:
            base += "?events=1"
        try:
            with urllib.request.urlopen(base, timeout=10) as rsp:
                payload = json.loads(rsp.read())
        except urllib.error.HTTPError as err:
            # the server ANSWERED — do not misreport it as unreachable:
            # 404 means an unknown cell (--explain typo) or a server
            # without a federation source, mirroring the offline path's
            # unknown-cell exit 3
            body = ""
            try:
                body = err.read().decode(errors="replace").strip()
            except OSError:
                pass
            print(body or f"{base}: HTTP {err.code}", file=sys.stderr)
            return 3 if err.code == 404 else 2
        except (OSError, ValueError, urllib.error.URLError) as err:
            print(f"cannot reach {base}: {err}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(payload))
            return 0
        if args.explain:
            print(render_cell_explanation(payload))
            return 0
        report = payload.get("report") if "report" in payload else payload
        if report is None:
            print("coordinator has not evaluated yet", file=sys.stderr)
            return 3
        print(render_federation_report(report))
        if args.events:
            for d in payload.get("events") or []:
                print("  " + events_mod.format_decision_line(d))
        breaker = (report or {}).get("breaker") or {}
        return 3 if (args.wait_exit_code and breaker.get("state") == "open")\
            else 0

    # offline: per-cell dumps + the federation policy JSON
    if not args.spec or not args.cell:
        print(
            "fedstatus needs --url (live), or --spec fed.json with one "
            "--cell name=dump.json per cell (offline), or --selftest",
            file=sys.stderr,
        )
        return 2
    from .api.federation_spec import FederationPolicySpec
    from .api.upgrade_spec import ValidationError
    from .cluster.inmem import InMemoryCluster

    try:
        with open(args.spec) as fh:
            spec = FederationPolicySpec.from_dict(json.load(fh))
        spec.validate()
    except (OSError, ValueError, ValidationError) as err:
        print(f"cannot load federation spec {args.spec}: {err}",
              file=sys.stderr)
        return 2
    clusters = {}
    for item in args.cell:
        name, _, path = item.partition("=")
        if not name or not path:
            print(
                f"--cell wants name=dump.json, got {item!r}", file=sys.stderr
            )
            return 2
        try:
            with open(path) as fh:
                clusters[name] = InMemoryCluster.from_dict(json.load(fh))
        except (OSError, ValueError) as err:
            print(f"cannot load cell dump {path}: {err}", file=sys.stderr)
            return 2
    try:
        report = federation_report_from_clusters(
            spec,
            clusters,
            args.namespace,
            _parse_selector_arg(args.selector),
        )
    except ValueError as err:
        print(str(err), file=sys.stderr)
        return 2
    merged = events_mod.merged_decisions_from_clusters(clusters)
    if args.explain:
        answer = explain_cell(args.explain, report, merged)
        if answer is None:
            print(f"unknown cell {args.explain!r}", file=sys.stderr)
            return 3
        print(json.dumps(answer) if args.json
              else render_cell_explanation(answer))
        return 0
    if args.json:
        out = dict(report)
        if args.events:
            out["events"] = merged
        print(json.dumps(out))
        return 0
    print(render_federation_report(report))
    if args.events:
        for d in merged:
            print("  " + events_mod.format_decision_line(d))
    breaker = report.get("breaker") or {}
    return 3 if (args.wait_exit_code and breaker.get("state") == "open") \
        else 0


def cmd_chaos(args: argparse.Namespace) -> int:
    """The chaos campaign engine (upgrade/chaos.py): run a declarative
    fault-scenario sweep and print the resilience scorecard.  Exit 0
    when every cell passes the rollout-invariant checker, 1 when any
    cell fails, 2 on usage errors.  ``--selftest`` runs one real
    brownout cell end-to-end and then proves the checker flags a
    deliberately broken invariant (the ``make verify-chaos`` gate)."""
    import logging as logging_mod

    from .upgrade import chaos as chaos_mod

    if not args.verbose:
        # absorbed-fault warnings are the scenarios doing their job;
        # they would drown the scorecard/selftest output
        logging_mod.getLogger("k8s_operator_libs_tpu_torch").setLevel(
            logging_mod.ERROR
        )
    if args.fleet is not None and args.fleet < 1:
        # same guard campaign_from_dict applies to the file's "fleet":
        # an empty fleet would burn max_cycles per cell and report a
        # misleading resilience failure instead of a usage error
        print(f"--fleet must be >= 1, got {args.fleet}", file=sys.stderr)
        return 2
    if args.mode == "search":
        return _cmd_chaos_search(args)
    if args.selftest:
        try:
            print(chaos_mod.selftest())
        except AssertionError as err:
            print(f"chaos selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    if args.list:
        for name in sorted(chaos_mod.SCENARIOS):
            s = chaos_mod.SCENARIOS[name]
            axes = (
                f"transport={'|'.join(s.transports)} "
                f"gates={'|'.join(s.gates)} "
                f"driver={'|'.join(s.drivers)}"
            )
            print(f"{name:<26} [{axes}]\n    {s.description}")
        return 0
    if args.campaign:
        try:
            with open(args.campaign, "r", encoding="utf-8") as fh:
                campaign = chaos_mod.campaign_from_dict(json.load(fh))
        except FileNotFoundError:
            print(f"campaign file not found: {args.campaign}", file=sys.stderr)
            return 2
        except OSError as err:
            print(
                f"cannot read campaign file {args.campaign}: {err}",
                file=sys.stderr,
            )
            return 2
        except (json.JSONDecodeError, ValueError, TypeError) as err:
            print(
                f"campaign file {args.campaign} is invalid: {err}",
                file=sys.stderr,
            )
            return 2
        # explicit CLI flags override the file (like --scenario/
        # --transport below) — reproducing a failed cell with a
        # different seed must not silently run the file's seed
        if args.seed is not None:
            campaign.seed = args.seed
        if args.fleet is not None:
            campaign.fleet_size = args.fleet
    else:
        campaign = chaos_mod.Campaign(
            seed=args.seed if args.seed is not None else 0,
            fleet_size=args.fleet if args.fleet is not None else 8,
        )
        if not args.scenario:
            # the DEFAULT campaign replays every ratcheted regression
            # cell after the matrix (the monotone-growth contract); a
            # --scenario filter or a campaign file opts out — the file
            # declares its own "regressions_file" when it wants them
            from .upgrade import chaossearch

            campaign.regression_cells = tuple(
                chaossearch.load_regression_cells()
            )
    if args.scenario:
        unknown = [
            s for s in args.scenario if s not in chaos_mod.SCENARIOS
        ]
        if unknown:
            print(
                f"unknown scenario(s) {', '.join(unknown)} — see "
                "`chaos --list`",
                file=sys.stderr,
            )
            return 2
        campaign.scenarios = tuple(args.scenario)
    if args.transport:
        campaign.transports = tuple(args.transport)
    if args.driver:
        campaign.drivers = tuple(args.driver)
    if not campaign.cells():
        print(
            "the campaign selects zero cells (scenario/transport axes "
            "exclude each other)",
            file=sys.stderr,
        )
        return 2
    progress = None
    if not args.json:
        progress = lambda msg: print(msg, file=sys.stderr)  # noqa: E731
    scorecard = chaos_mod.run_campaign(campaign, progress=progress)
    if args.json:
        print(json.dumps(scorecard))
    else:
        print(chaos_mod.render_scorecard(scorecard))
    return 0 if scorecard["cells_failed"] == 0 else 1


def _cmd_chaos_search(args: argparse.Namespace) -> int:
    """``chaos search``: the fitness-guided mutation searcher
    (upgrade/chaossearch.py).  Exit 0 when no mutated cell violated an
    invariant within the budget, 1 when the search FOUND a violation
    (that is the searcher succeeding at its job — the finding needs a
    fix), 2 on usage errors.  ``--shrink`` reduces each finding to a
    minimal reproducer; ``--ratchet [PATH]`` appends reproducers to
    the regression-cell file the default campaign replays."""
    from .upgrade import chaossearch

    progress = None
    if not args.json:
        progress = lambda msg: print(msg, file=sys.stderr)  # noqa: E731
    if args.selftest:
        try:
            print(chaossearch.selftest(progress=progress))
        except AssertionError as err:
            print(
                f"chaos search selftest FAILED: {err}", file=sys.stderr
            )
            return 1
        return 0
    table = chaossearch.resolve_scenarios()
    unknown = [s for s in args.scenario if s not in table]
    if unknown:
        print(
            f"unknown scenario(s) {', '.join(unknown)} — see "
            "`chaos --list`",
            file=sys.stderr,
        )
        return 2
    if args.generations < 1 or args.population < 1 or args.budget < 1:
        print(
            "--generations/--population/--budget must be >= 1",
            file=sys.stderr,
        )
        return 2
    config = chaossearch.SearchConfig(
        seed=args.seed if args.seed is not None else 0,
        generations=args.generations,
        population=args.population,
        budget_cells=args.budget,
        fleet_size=args.fleet if args.fleet is not None else 5,
        scenarios=tuple(args.scenario),
        transports=tuple(args.transport) or ("inmem", "http"),
    )
    result = chaossearch.run_search(config, progress=progress)
    reproducers = []
    ratcheted = []
    if result["found"] and (args.shrink or args.ratchet is not None):
        for finding in result["found"]:
            rep = chaossearch.shrink(
                config.seed, finding["candidate"], progress=progress
            )
            reproducers.append(rep)
            if args.ratchet is not None:
                ratcheted.append(
                    chaossearch.ratchet_cell(
                        rep,
                        path=args.ratchet or None,
                        note="chaos search",
                    )
                )
    if args.json:
        print(
            json.dumps(
                {
                    **result,
                    "reproducers": reproducers,
                    "ratcheted": ratcheted,
                }
            )
        )
    else:
        gens = result["generations"]
        best = result["best_fitness"]
        print(
            f"chaos search (seed {config.seed}): "
            f"{result['cells_run']} cells over {len(gens)} "
            f"generation(s), best fitness {best}, "
            f"{len(result['found'])} violation(s) found "
            f"in {result['wall_s']:.1f}s"
        )
        for g in gens:
            print(
                f"  gen {g['generation']}: best={g['best_fitness']} "
                f"mean={g['mean_fitness']} cells={g['cells_run']}"
            )
        for f in result["found"]:
            print(
                f"  FOUND {f['candidate']['scenario']}"
                f"/{f['candidate']['transport']}"
                f"/gates-{f['candidate']['gates']}"
                f"/{f['candidate']['driver']} "
                f"seed={f['seed']}: {', '.join(f['violations'])}"
            )
        for rep in reproducers:
            print(
                "  shrunk to "
                f"{json.dumps(rep['candidate']['mutations'])} "
                f"fleet={rep['candidate']['fleet']} "
                f"seed={rep['seed']} in {rep['runs']} runs"
            )
        for r in ratcheted:
            mark = "ratcheted" if r["added"] else "already ratcheted"
            print(f"  {mark}: {r['cell']['cell']} -> {r['path']}")
    return 1 if result["found"] else 0


def _load_profile_dump(path: str):
    """A profile dump from disk: native/speedscope JSON or collapsed
    text, normalized to ``(snapshot_dict, collapsed_counts)``.  Raises
    the same exception families the other offline loaders map to exit
    code 2."""
    from .obs import profiling

    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        counts = profiling.parse_collapsed(text)  # ValueError when neither
        snapshot = {
            "running": False,
            "windows": [
                {
                    "started_unix": 0.0,
                    "samples": sum(counts.values()),
                    "stacks": counts,
                    "span_self": {},
                    "span_total": {},
                    "span_frames": {},
                }
            ],
        }
        return snapshot, counts
    snapshot = profiling.snapshot_from_payload(payload)
    return snapshot, profiling.merged_stacks(snapshot)


def cmd_profile(args: argparse.Namespace) -> int:
    """The profiling plane's CLI: ``--selftest`` (the ``make
    verify-profile`` gate), ``diff A B`` (top regressing frames between
    two dumps), offline rendering of a saved ``/debug/profile`` dump,
    or live capture from a running operator's endpoint."""
    from .obs import profiling

    if args.selftest:
        try:
            print(profiling.selftest())
        except AssertionError as err:
            print(f"profile selftest FAILED: {err}", file=sys.stderr)
            return 1
        return 0

    # ---- `profile diff OLD NEW`: the differential workflow
    if args.paths:
        if args.paths[0] != "diff" or len(args.paths) != 3:
            print(
                "usage: profile diff OLD NEW   (two saved dumps: native/"
                "speedscope JSON or collapsed text)",
                file=sys.stderr,
            )
            return 2
        try:
            _, old_counts = _load_profile_dump(args.paths[1])
            _, new_counts = _load_profile_dump(args.paths[2])
        except FileNotFoundError as err:
            print(f"profile dump not found: {err.filename}", file=sys.stderr)
            return 2
        except OSError as err:
            print(f"cannot read profile dump: {err}", file=sys.stderr)
            return 2
        except (ValueError, TypeError, KeyError) as err:
            print(f"not a profile dump: {err}", file=sys.stderr)
            return 2
        regressions = profiling.diff_collapsed(
            old_counts, new_counts, top=args.top
        )
        if args.json:
            print(json.dumps(regressions))
            return 0
        if not regressions:
            print("no frames in either dump")
            return 0
        print(f"{'delta':>8} {'old':>7} {'new':>7}  frame  (+ = slower in NEW)")
        for entry in regressions:
            print(
                f"{entry['delta_pct']:+7.2f}p {entry['old_pct']:6.2f}% "
                f"{entry['new_pct']:6.2f}%  {entry['frame']}"
            )
        return 0

    # ---- resolve ONE snapshot source: --file | --url
    if args.file and args.url:
        print(
            "profile takes ONE source: --file DUMP or --url BASE, not both",
            file=sys.stderr,
        )
        return 2
    locks_payload = None
    if args.file:
        try:
            snapshot, _ = _load_profile_dump(args.file)
            if getattr(args, "locks", False):
                with open(args.file, "r", encoding="utf-8") as fh:
                    raw = json.load(fh)
                if isinstance(raw, dict):
                    locks_payload = raw.get("locks")
        except FileNotFoundError:
            print(f"profile dump not found: {args.file}", file=sys.stderr)
            return 2
        except OSError as err:
            print(f"cannot read profile dump {args.file}: {err}", file=sys.stderr)
            return 2
        except (ValueError, TypeError, KeyError) as err:
            print(
                f"profile dump {args.file} is not a profile dump: {err}",
                file=sys.stderr,
            )
            return 2
    elif args.url:
        import urllib.error
        import urllib.request

        url = args.url.rstrip("/") + "/debug/profile"
        params = []
        if args.seconds:
            params.append(f"seconds={args.seconds:g}")
        if getattr(args, "locks", False):
            params.append("locks=1")
        if params:
            url += "?" + "&".join(params)
        try:
            with urllib.request.urlopen(
                url, timeout=max(30.0, args.seconds + 30.0)
            ) as resp:
                payload = json.loads(resp.read().decode())
                if isinstance(payload, dict):
                    locks_payload = payload.get("locks")
                snapshot = profiling.snapshot_from_payload(payload)
        except (urllib.error.URLError, OSError, ValueError) as err:
            print(f"cannot capture from {url}: {err}", file=sys.stderr)
            return 2
    else:
        print(
            "profile needs a source: --file DUMP, --url BASE "
            "(or `diff OLD NEW` / --selftest)",
            file=sys.stderr,
        )
        return 2

    if args.fmt == "collapsed":
        sys.stdout.write(profiling.to_collapsed(snapshot))
    elif args.fmt == "speedscope":
        print(json.dumps(profiling.to_speedscope(snapshot)))
    elif args.json:
        out = snapshot
        if getattr(args, "locks", False) and locks_payload is not None:
            out = dict(snapshot, locks=locks_payload)
        print(json.dumps(out))
    else:
        print(profiling.render_report(snapshot, top=args.top))
        if getattr(args, "locks", False):
            from .obs import racewatch

            if locks_payload is None:
                print(
                    "\nracewatch: no lock data in this source (serve "
                    "/debug/profile?locks=1 from a RACEWATCH=1 process)"
                )
            else:
                print()
                print(racewatch.render_report(locks_payload, top=args.top))
    return 0


def cmd_repair(args: argparse.Namespace) -> int:
    """Codify the upgrade-failed runbook: delete a failed node's driver
    pod so the DaemonSet recreates it at the target revision and the
    state machine self-heals the node to done (common_manager's
    failed-recovery processor).  Dry-run by default; ``--yes`` applies."""
    if args.state_file:
        print(
            "repair writes to the cluster: it needs a live source "
            "(--kubeconfig/--in-cluster), not a dump",
            file=sys.stderr,
        )
        return 2
    cluster, rc = _open_source(args, "repair")
    if cluster is None:
        return rc
    util.set_component_name(args.component)
    from .cluster.errors import ApiError
    from .upgrade import consts as upgrade_consts

    state_key = util.get_upgrade_state_label_key()
    selector = args.selector
    try:
        nodes = cluster.list("Node")
        failed = [
            n["metadata"]["name"]
            for n in nodes
            if (n["metadata"].get("labels") or {}).get(state_key)
            == upgrade_consts.UPGRADE_STATE_FAILED
            and (not args.node or n["metadata"]["name"] == args.node)
        ]
        driver_pods = cluster.list(
            "Pod", namespace=args.namespace, label_selector=selector
        )
        plan = [
            (name, pod["metadata"]["name"], args.namespace)
            for name in failed
            for pod in driver_pods
            if (pod.get("spec") or {}).get("nodeName") == name
        ]
    except (ApiError, OSError) as err:
        print(f"cannot read cluster state: {err}", file=sys.stderr)
        return 2
    if args.node and not failed:
        print(
            f"node {args.node} is not in upgrade-failed; nothing to repair",
            file=sys.stderr,
        )
        return 3
    if args.json and not args.yes:
        # Dry run: the machine output IS the plan.
        print(
            json.dumps(
                [
                    {"node": n, "pod": p, "namespace": ns}
                    for n, p, ns in plan
                ]
            )
        )
    elif not args.json:
        if not plan:
            print("no failed nodes with driver pods found; nothing to repair")
        else:
            for node, pod, ns in plan:
                print(
                    f"{node}: delete driver pod {ns}/{pod} "
                    "(DS recreates at target)"
                )
    if not plan:
        if args.json and args.yes:
            print(json.dumps([]))
        return 0
    if not args.yes:
        if not args.json:
            print(
                f"dry run — would repair {len(plan)} pod(s); re-run with "
                "--yes to apply",
            )
        return 0
    errors = 0
    from .cluster.errors import NotFoundError

    # With --yes the machine output reports what actually HAPPENED, not
    # the pre-apply plan: each entry carries applied/error so JSON
    # consumers never have to reverse-engineer outcomes from stderr and
    # the exit code.
    results = []
    for node, pod, ns in plan:
        entry = {"node": node, "pod": pod, "namespace": ns, "applied": True}
        try:
            cluster.delete("Pod", pod, ns)
        except NotFoundError:
            entry["applied"] = False
            entry["error"] = "already gone (DaemonSet beat us to it)"
        except (ApiError, OSError) as err:
            entry["applied"] = False
            entry["error"] = str(err)
            print(f"failed to delete {ns}/{pod}: {err}", file=sys.stderr)
            errors += 1
        results.append(entry)
    if args.json:
        print(json.dumps(results))
    else:
        print(
            f"repaired {len(plan) - errors}/{len(plan)} pod(s); failed "
            "nodes self-heal once their pods return in sync at the "
            "target revision"
        )
    return 0 if errors == 0 else 1


def _add_source_args(sp: argparse.ArgumentParser) -> None:
    """How to OPEN the cluster (shared by every read-only subcommand)."""
    sp.add_argument(
        "--state-file", default="", help="cluster dump JSON (offline mode)"
    )
    sp.add_argument(
        "--kubeconfig",
        nargs="?",
        const="",
        default=None,
        help="live mode against a real cluster (no value = $KUBECONFIG "
        "then ~/.kube/config)",
    )
    sp.add_argument("--context", default=None)
    sp.add_argument("--in-cluster", action="store_true")
    sp.add_argument("--json", action="store_true", help="machine output")


def _add_query_args(sp: argparse.ArgumentParser) -> None:
    """WHAT to query: the driver-fleet coordinates status/plan snapshot
    on (history reads raw Events and takes none of these)."""
    sp.add_argument("--namespace", default="tpu-ops")
    sp.add_argument(
        "--selector",
        default="app=gpu-driver",
        help="driver DaemonSet label selector, key=value[,key=value...]",
    )
    sp.add_argument(
        "--component",
        default="gpu-driver",
        help="managed component name (parameterizes the label keys)",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_operator_libs_tpu_torch",
        description="TPU-fleet orchestration library CLI",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    st = sub.add_parser("status", help="print rollout status")
    _add_source_args(st)
    _add_query_args(st)
    st.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source; when set, the admission "
        "gates (canary/window/pacing) are evaluated and any freeze is "
        "explained",
    )
    st.add_argument(
        "--wait-exit-code",
        action="store_true",
        help="exit 3 while the rollout is incomplete (poll-friendly)",
    )
    st.add_argument(
        "--watch",
        action="store_true",
        help="block until the rollout completes, printing the status "
        "whenever it changes (kubectl rollout status behavior; live "
        "sources only)",
    )
    st.add_argument(
        "--interval",
        type=_positive_float,
        default=2.0,
        help="poll interval for --watch (seconds, > 0)",
    )
    st.set_defaults(func=cmd_status)

    pl = sub.add_parser(
        "plan",
        help="dry-run: simulate the next reconcile cycles, print projected "
        "admissions/transitions and gates; never writes",
    )
    _add_source_args(pl)
    _add_query_args(pl)
    pl.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source to plan with "
        "(default: reference-default policy)",
    )
    pl.add_argument(
        "--cycles",
        type=int,
        default=0,
        help="simulation horizon in reconcile cycles (0 = until "
        "convergence or steady state, capped)",
    )
    pl.add_argument(
        "--requestor",
        action="store_true",
        help="plan the requestor-mode handoff (NodeMaintenance CRs; a "
        "simulated maintenance operator grants Ready optimistically)",
    )
    pl.add_argument(
        "--requestor-id",
        default="",
        help="requestor identity for --requestor (default: "
        "$MAINTENANCE_OPERATOR_REQUESTOR_ID, else 'plan-preview')",
    )
    pl.add_argument(
        "--requestor-namespace",
        default="",
        help="NodeMaintenance namespace for --requestor (default: "
        "$MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE, else 'default')",
    )
    pl.add_argument(
        "--validation-selector",
        default="",
        help="enable the validation state with this pod label selector "
        "(validation pods are synthesized Ready — optimistic)",
    )
    pl.set_defaults(func=cmd_plan)

    hi = sub.add_parser(
        "history",
        help="per-node upgrade timeline from the cluster-visible Events "
        "the operator writes (kubectl rollout history analog)",
    )
    _add_source_args(hi)
    hi.add_argument("--node", default="", help="only this node's events")
    hi.add_argument(
        "--events-namespace",
        default="",
        help="namespace holding the Event objects (default: all "
        "namespaces, like kubectl get events -A)",
    )
    hi.add_argument(
        "--source",
        default="",
        help="only Events from this source.component — on a real "
        "cluster Node events are mostly kubelet/node-controller noise; "
        "pass the operator's recorder component (\"<name>Upgrade\") for "
        "the pure upgrade timeline (default: all components)",
    )
    hi.set_defaults(func=cmd_history)

    tr = sub.add_parser(
        "traces",
        help="pretty-print or re-export a reconcile trace dump saved from "
        "the operator's /debug/traces endpoint; --selftest smokes the "
        "tracing pipeline",
    )
    tr.add_argument(
        "--file",
        default="",
        help="trace dump JSON (native, OTLP-flavoured, or Chrome — the "
        "three shapes /debug/traces serves)",
    )
    tr.add_argument(
        "--trace-id", default="", help="only this trace from the dump"
    )
    tr.add_argument(
        "--fmt",
        choices=("tree", "chrome", "otlp"),
        default="tree",
        help="output: human span tree (default), chrome://tracing JSON, "
        "or OTLP-flavoured JSON",
    )
    tr.add_argument(
        "--json",
        action="store_true",
        help="machine output (native trace dicts; with --fmt chrome/otlp "
        "the output is already JSON)",
    )
    tr.add_argument(
        "--selftest",
        action="store_true",
        help="run the tracing pipeline end-to-end (spans, propagation, "
        "both exporters) and exit 0/1 — the make verify-obs smoke",
    )
    tr.set_defaults(func=cmd_traces)

    rm = sub.add_parser(
        "remediation",
        help="inspect the remediation engine: breaker state, last-known-"
        "good records, per-node retry budgets and quarantines; "
        "--selftest smokes the breaker/rollback loop end-to-end",
    )
    _add_source_args(rm)
    _add_query_args(rm)
    rm.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source (annotates whether the "
        "engine is enabled; the records render either way)",
    )
    rm.add_argument(
        "--wait-exit-code",
        action="store_true",
        help="exit 3 while the breaker blocks admissions (poll-friendly)",
    )
    rm.add_argument(
        "--selftest",
        action="store_true",
        help="run the in-memory breaker trip + LKG rollback smoke and "
        "exit 0/1 — the make verify-remediation gate (no source needed)",
    )
    rm.set_defaults(func=cmd_remediation)

    sl = sub.add_parser(
        "slo",
        help="rollout SLO report: per-phase p50/p95/p99, fleet ETA with "
        "confidence band, stragglers, and declared-SLO breach/burn "
        "evaluation (timelines reconstructed from the flight recorder's "
        "node-annotation checkpoints); --selftest smokes the pipeline "
        "end-to-end",
    )
    _add_source_args(sl)
    _add_query_args(sl)
    sl.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source; when it declares an "
        "slos block, breaches and burn rates are evaluated (analytics "
        "render either way)",
    )
    sl.add_argument(
        "--wait-exit-code",
        action="store_true",
        help="exit 3 while a declared SLO is in breach (poll-friendly)",
    )
    sl.add_argument(
        "--selftest",
        action="store_true",
        help="run the flight-recorder→analytics→breach smoke end-to-end "
        "and exit 0/1 — the make verify-slo gate (no source needed)",
    )
    sl.set_defaults(func=cmd_slo)

    pc = sub.add_parser(
        "pacing",
        help="analysis gates + adaptive pacing: the active step's "
        "advance/abort condition values, the exposure cap, and the "
        "AIMD wave scale (offline approximation; the live stateful "
        "report is OpsServer /debug/analysis); --selftest smokes the "
        "closed loop end-to-end (soak auto-advance -> throttle -> "
        "abort-to-LKG)",
    )
    _add_source_args(pc)
    _add_query_args(pc)
    pc.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source (must declare an "
        "analysis block)",
    )
    pc.add_argument(
        "--wait-exit-code",
        action="store_true",
        help="exit 3 while an abort condition holds (poll-friendly)",
    )
    pc.add_argument(
        "--selftest",
        action="store_true",
        help="run the closed-loop smoke — gated fleet auto-advances a "
        "canary soak, throttles under injected burn, aborts to the "
        "LKG — and exit 0/1; the make verify-pacing gate (no source "
        "needed)",
    )
    pc.set_defaults(func=cmd_pacing)

    ex = sub.add_parser(
        "explain",
        help="answer 'why is node X not progressing' with a machine-"
        "readable reason code: current phase, first blocking gate, "
        "retry/backoff state and the fleet ETA — offline from a dump or "
        "live; --selftest smokes the decision-event pipeline end-to-end",
    )
    _add_source_args(ex)
    _add_query_args(ex)
    ex.add_argument("--node", default="", help="the node to explain")
    ex.add_argument(
        "--policy",
        default="",
        help="GpuUpgradePolicy name in the source; when set, the admission "
        "gates are evaluated so a gate-blocked node names its gate",
    )
    ex.add_argument(
        "--selftest",
        action="store_true",
        help="run the fleet → deferral → breaker-trip → explain smoke "
        "across all three planes and exit 0/1 — the make verify-events "
        "gate (no source needed)",
    )
    ex.set_defaults(func=cmd_explain)

    ev = sub.add_parser(
        "events",
        help="list the reason-coded decision-audit stream from the "
        "source's persisted Event objects (live stream: OpsServer "
        "/debug/events); --selftest smokes the pipeline end-to-end",
    )
    _add_source_args(ev)
    _add_query_args(ev)
    ev.add_argument("--node", default="", help="only this node's decisions")
    ev.add_argument(
        "--type", default="", help="only this decision type (e.g. NodeDeferred)"
    )
    ev.add_argument(
        "--selftest",
        action="store_true",
        help="same end-to-end smoke as `explain --selftest`",
    )
    ev.set_defaults(func=cmd_events)

    fd = sub.add_parser(
        "fedstatus",
        help="fleet-of-fleets federation status (federation/): cell "
        "phases, the global breaker, the ETA rollup, per-cell explain "
        "and the merged cross-cluster audit trail — live from a "
        "coordinator's /debug/federation or offline from per-cell "
        "dumps; --selftest runs the 3-cell e2e over real HTTP",
    )
    _add_query_args(fd)
    fd.add_argument("--json", action="store_true", help="machine output")
    fd.add_argument(
        "--url",
        default="",
        help="live mode: the coordinator ops server base URL "
        "(e.g. http://127.0.0.1:8080)",
    )
    fd.add_argument(
        "--spec",
        default="",
        help="offline mode: FederationPolicySpec JSON file",
    )
    fd.add_argument(
        "--cell",
        action="append",
        default=[],
        metavar="NAME=DUMP.json",
        help="offline mode: one per cell — the cell's cluster dump",
    )
    fd.add_argument(
        "--explain",
        default="",
        metavar="CELL",
        help="answer 'why is cell CELL not promoting'",
    )
    fd.add_argument(
        "--events",
        action="store_true",
        help="include the merged cross-cluster decision stream",
    )
    fd.add_argument(
        "--wait-exit-code",
        action="store_true",
        help="exit 3 while the global breaker is open (poll-friendly)",
    )
    fd.add_argument(
        "--selftest",
        action="store_true",
        help="3-cell canary→region→global e2e over real HTTP: healthy "
        "wave promotes in order, injected cell breach trips the global "
        "breaker, holds the wave and rolls back to the LKG "
        "(make verify-federation)",
    )
    fd.set_defaults(func=cmd_fedstatus)

    ch = sub.add_parser(
        "chaos",
        help="chaos campaign engine: declarative fault-scenario sweeps "
        "(brownouts, partitions, 410 storms, failovers, GC races...) "
        "crossed with config axes, every cell checked by the rollout-"
        "invariant checker against the decision stream; exit 1 when any "
        "cell fails; --selftest smokes the engine AND proves the "
        "checker can fail",
    )
    ch.add_argument(
        "mode",
        nargs="?",
        choices=("run", "search"),
        default="run",
        help="run = sweep the campaign matrix (default); search = "
        "fitness-guided mutation search over the fault space "
        "(upgrade/chaossearch.py): mutate cell parameters generation "
        "over generation, score by proximity to an invariant "
        "violation, exit 1 when one is found",
    )
    ch.add_argument(
        "--campaign",
        default="",
        help="campaign file (JSON: name/seed/fleet/scenarios/axes/"
        "regression_cells/regressions_file); default: the full "
        "built-in campaign plus every ratcheted regression cell",
    )
    ch.add_argument(
        "--scenario",
        action="append",
        default=[],
        help="run only this scenario (repeatable; see --list)",
    )
    ch.add_argument(
        "--transport",
        action="append",
        choices=("inmem", "http"),
        default=[],
        help="restrict the transport axis (repeatable)",
    )
    ch.add_argument(
        "--driver",
        action="append",
        choices=("polling", "event"),
        default=[],
        help="restrict the reconcile-driver axis (repeatable): "
        "'polling' = one pass per cycle, 'event' = passes scheduled "
        "by workqueue wakeups (journal deltas, worker completions)",
    )
    ch.add_argument(
        "--seed",
        type=int,
        default=None,
        help="campaign seed (per-cell seeds derive from it "
        "deterministically; overrides a --campaign file's; default 0)",
    )
    ch.add_argument(
        "--fleet",
        type=int,
        default=None,
        help="nodes per cell fleet (overrides a --campaign file's; "
        "default 8)",
    )
    ch.add_argument(
        "--list", action="store_true", help="print the scenario catalog"
    )
    ch.add_argument(
        "--verbose",
        action="store_true",
        help="keep the library's absorbed-fault warnings on stderr",
    )
    ch.add_argument("--json", action="store_true", help="machine output")
    ch.add_argument(
        "--selftest",
        action="store_true",
        help="run mode: one real brownout cell end-to-end then prove "
        "the checker flags a deliberately broken invariant (the make "
        "verify-chaos gate); search mode: plant a known bug, climb to "
        "it, shrink it, ratchet it, replay it green once fixed (the "
        "make verify-chaos-search gate)",
    )
    ch.add_argument(
        "--generations",
        type=int,
        default=3,
        help="search mode: breeding generations (default 3)",
    )
    ch.add_argument(
        "--population",
        type=int,
        default=6,
        help="search mode: candidates per generation (default 6)",
    )
    ch.add_argument(
        "--budget",
        type=int,
        default=48,
        help="search mode: max NEW cell evaluations across the whole "
        "search (cached elites are free; default 48)",
    )
    ch.add_argument(
        "--shrink",
        action="store_true",
        help="search mode: delta-debug each finding down to a minimal "
        "deterministic reproducer",
    )
    ch.add_argument(
        "--ratchet",
        nargs="?",
        const="",
        default=None,
        metavar="PATH",
        help="search mode: append each shrunk reproducer to the "
        "regression-cell file (implies --shrink; default PATH: "
        "k8s_operator_libs_tpu_torch/hack/chaos_regressions.json, "
        "replayed by the default "
        "campaign)",
    )
    ch.set_defaults(func=cmd_chaos)

    pf = sub.add_parser(
        "profile",
        help="continuous-profiling plane: live-capture from a running "
        "operator's /debug/profile, render a saved dump (span self-time "
        "table + top frames / collapsed stacks / speedscope JSON), or "
        "`profile diff OLD NEW` for the top regressing frames; "
        "--selftest smokes the pipeline end-to-end",
    )
    pf.add_argument(
        "paths",
        nargs="*",
        metavar="diff OLD NEW",
        help="diff mode: compare two saved dumps (native/speedscope "
        "JSON or collapsed text) and print the top regressing frames",
    )
    pf.add_argument(
        "--file",
        default="",
        help="saved profile dump to render (any shape /debug/profile or "
        "this CLI emits: native JSON, speedscope JSON, collapsed text)",
    )
    pf.add_argument(
        "--url",
        default="",
        help="live capture: base URL of a running operator's OpsServer "
        "(e.g. http://127.0.0.1:8080); fetches /debug/profile",
    )
    pf.add_argument(
        "--seconds",
        type=float,
        default=0.0,
        help="with --url: block for an on-demand capture window of this "
        "many seconds instead of reading the continuous ring",
    )
    pf.add_argument(
        "--fmt",
        choices=("report", "collapsed", "speedscope"),
        default="report",
        help="output: human report (span self/child table + top "
        "self-time frames, default), collapsed stacks (flamegraph.pl / "
        "speedscope importable), or speedscope.app JSON",
    )
    pf.add_argument(
        "--top",
        type=int,
        default=10,
        help="rows in the top-frames / diff tables",
    )
    pf.add_argument(
        "--locks",
        action="store_true",
        help="append the racewatch lock section (per-site hold/"
        "contention stats + lock-order cycles): with --url fetches "
        "?locks=1, with --file reads the dump's locks key (only "
        "present when the serving process ran RACEWATCH=1)",
    )
    pf.add_argument(
        "--json",
        action="store_true",
        help="machine output (native snapshot; with --fmt speedscope "
        "the output is already JSON)",
    )
    pf.add_argument(
        "--selftest",
        action="store_true",
        help="run the sampler → span attribution → /debug/profile → "
        "diff smoke end-to-end and exit 0/1 — the make verify-profile "
        "gate (no source needed)",
    )
    pf.set_defaults(func=cmd_profile)

    rp = sub.add_parser(
        "repair",
        help="replace the driver pods of upgrade-failed nodes so they "
        "self-heal (the documented runbook step; dry-run unless --yes)",
    )
    _add_source_args(rp)
    _add_query_args(rp)
    rp.add_argument("--node", default="", help="repair only this node")
    rp.add_argument(
        "--yes",
        action="store_true",
        help="actually delete the pods (default: dry-run listing)",
    )
    rp.set_defaults(func=cmd_repair)

    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except BrokenPipeError:
        # Downstream pager/head closed the pipe.  Exit 141 (128+SIGPIPE,
        # the shell convention) — NOT 0, which --wait-exit-code consumers
        # would misread as "rollout complete".
        sys.stderr.close()
        return 141
    except KeyboardInterrupt:
        # Ctrl-C is how a user leaves --watch: exit 130 (128+SIGINT)
        # cleanly, no traceback — kubectl rollout status behavior.
        return 130


if __name__ == "__main__":
    sys.exit(main())

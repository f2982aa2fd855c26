#!/usr/bin/env python
"""Example CLI: apply or delete CRDs from YAML files/directories.

The port of the JAX package's ``examples/apply_crds.py``, with the same
flags and output lines.  Reference parity: ``examples/apply-crds/main.go:34-61`` — a flag-driven
wrapper over the crdutil package; consumers containerize this pattern as a
Helm pre-install/pre-upgrade hook (pkg/crdutil/README.md:30-63).

Backends:

* ``--kubeconfig [PATH]`` / ``--in-cluster`` — a REAL cluster via
  :class:`KubeApiClient` (the reference's ctrl.GetConfig path,
  crdutil.go:56-67); PATH defaults to $KUBECONFIG then ~/.kube/config.
* default — the library's in-memory apiserver, optionally persisted to
  a JSON file between invocations (``--state-file``), so apply → delete
  flows are observable across runs without any cluster:

    python -m k8s_operator_libs_tpu_torch.examples.apply_crds \
        --crds-path k8s_operator_libs_tpu_torch/crd --state-file /tmp/s.json
    python -m k8s_operator_libs_tpu_torch.examples.apply_crds \
        --crds-path k8s_operator_libs_tpu_torch/crd --operation delete \
        --state-file /tmp/s.json

The package's own CRDs (``crd/``) are JSON, which a YAML parser reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..cluster.inmem import InMemoryCluster
from ..crdutil import (
    CRDProcessorConfig,
    OPERATION_APPLY,
    OPERATION_DELETE,
    discovery,
    process_crds_with_config,
)


def load_cluster(state_file: str | None) -> InMemoryCluster:
    if state_file and os.path.exists(state_file):
        with open(state_file, "r", encoding="utf-8") as fh:
            return InMemoryCluster.from_dict(json.load(fh))
    return InMemoryCluster()


def save_cluster(cluster: InMemoryCluster, state_file: str | None) -> None:
    if not state_file:
        return
    with open(state_file, "w", encoding="utf-8") as fh:
        json.dump(cluster.to_dict(), fh, indent=2, default=str)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # Flag names mirror the reference CLI (examples/apply-crds/main.go:34-38).
    parser.add_argument(
        "--crds-path",
        action="append",
        required=True,
        help="file or directory containing CRD YAML (repeatable)",
    )
    parser.add_argument(
        "--operation",
        choices=[OPERATION_APPLY, OPERATION_DELETE],
        default=OPERATION_APPLY,
    )
    parser.add_argument(
        "--ready-timeout-seconds", type=float, default=10.0,
        help="how long to wait for applied CRDs to be served",
    )
    parser.add_argument(
        "--state-file",
        default=None,
        help="JSON file persisting the in-memory cluster between runs",
    )
    parser.add_argument(
        "--kubeconfig",
        nargs="?",
        const="",
        default=None,
        help="run against a real cluster via this kubeconfig "
        "(no value = $KUBECONFIG then ~/.kube/config)",
    )
    parser.add_argument(
        "--context", default=None, help="kubeconfig context override"
    )
    parser.add_argument(
        "--in-cluster",
        action="store_true",
        help="use the ServiceAccount-mounted in-cluster config",
    )
    args = parser.parse_args(argv)

    if (args.kubeconfig is not None or args.in_cluster) and args.state_file:
        parser.error("--state-file only applies to the in-memory backend")

    if args.in_cluster:
        from ..cluster import KubeApiClient, KubeConfig

        cluster = KubeApiClient(KubeConfig.in_cluster())
    elif args.kubeconfig is not None:
        from ..cluster import KubeApiClient, KubeConfig

        cluster = KubeApiClient(
            KubeConfig.load(args.kubeconfig or None, context=args.context)
        )
    else:
        cluster = load_cluster(args.state_file)
    config = CRDProcessorConfig(
        paths=args.crds_path,
        operation=args.operation,
        ready_timeout_seconds=args.ready_timeout_seconds,
    )
    try:
        crds = process_crds_with_config(cluster, config)
    except Exception as err:  # mirror the reference's fatal-log exit
        print(f"error: {err}", file=sys.stderr)
        return 1
    save_cluster(cluster, args.state_file)

    names = [c["metadata"]["name"] for c in crds]
    print(f"{args.operation}: processed {len(crds)} CRD(s): {', '.join(names)}")
    if args.operation == OPERATION_APPLY:
        print("served:", ", ".join("/".join(t) for t in sorted(discovery(cluster))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

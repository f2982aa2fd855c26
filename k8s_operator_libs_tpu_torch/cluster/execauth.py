"""Exec credential-plugin auth (client.authentication.k8s.io).

Real GPU fleets live behind managed control planes whose kubeconfigs
carry **no static credential**: GKE uses ``gke-gcloud-auth-plugin``,
EKS ``aws eks get-token`` — both via the ``user.exec`` stanza.  The
reference inherits this transparently from client-go's exec authenticator
(pulled in at go.mod:11-16 and loaded via ``ctrl.GetConfig()``,
crdutil.go:56-67).  This module is the stdlib equivalent:

* run the configured command with its args + env additions;
* parse the ``ExecCredential`` JSON it prints on stdout
  (``status.token`` for bearer auth, or
  ``status.clientCertificateData``/``clientKeyData`` — PEM, per the
  API — for mTLS);
* cache the credential until ``status.expirationTimestamp`` (RFC 3339)
  and re-run the plugin on expiry or on a forced refresh (the client
  forces one when the apiserver answers 401, matching client-go's
  behavior for server-side revocation before the stamped expiry);
* honor ``interactiveMode``: ``Always`` fails fast (no TTY here),
  ``Never``/``IfAvailable`` run non-interactively;
* pass ``KUBERNETES_EXEC_INFO`` with cluster info when
  ``provideClusterInfo: true`` (plugins like gke-gcloud-auth-plugin use
  it for endpoint routing).

Legacy ``user.auth-provider`` blocks remain a loud
:class:`~.kubeclient.KubeConfigError` — that API was removed upstream
and plugins replaced it.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import tempfile
import threading
import weakref
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional


class ExecCredentialError(Exception):
    """The plugin failed to produce a usable credential."""


#: Live plugins whose materialized PEM files must be removed at process
#: exit (they hold private-key material).  Weak references: a plugin
#: garbage-collected earlier cleans up via its finalizer instead.
_LIVE_PLUGINS: "weakref.WeakSet[ExecCredentialPlugin]" = weakref.WeakSet()


def _cleanup_all_plugins() -> None:
    for plugin in list(_LIVE_PLUGINS):
        plugin.cleanup()


atexit.register(_cleanup_all_plugins)


@dataclass
class ExecCredential:
    """One issued credential (the parsed ``status`` block)."""

    token: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    expiration: Optional[datetime] = None

    def expired(self, skew_seconds: float = 10.0) -> bool:
        """True once within *skew_seconds* of the stamped expiry (issue a
        fresh credential slightly early rather than racing the server)."""
        if self.expiration is None:
            return False
        return datetime.now(timezone.utc) >= self.expiration - timedelta(
            seconds=skew_seconds
        )


def _parse_rfc3339(stamp: str) -> datetime:
    try:
        parsed = datetime.fromisoformat(stamp.replace("Z", "+00:00"))
    except ValueError as err:
        raise ExecCredentialError(
            f"bad expirationTimestamp {stamp!r}: {err}"
        ) from err
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=timezone.utc)
    return parsed


@dataclass
class ExecPluginSpec:
    """The kubeconfig ``user.exec`` stanza (fields this client honors)."""

    command: str
    api_version: str = "client.authentication.k8s.io/v1"
    args: List[str] = field(default_factory=list)
    env: List[Dict[str, str]] = field(default_factory=list)
    interactive_mode: str = "IfAvailable"
    provide_cluster_info: bool = False
    install_hint: str = ""

    @classmethod
    def from_kubeconfig(cls, spec: dict) -> "ExecPluginSpec":
        command = spec.get("command")
        if not command:
            raise ExecCredentialError("user.exec stanza has no command")
        return cls(
            command=command,
            api_version=spec.get(
                "apiVersion", "client.authentication.k8s.io/v1"
            ),
            args=list(spec.get("args") or []),
            env=list(spec.get("env") or []),
            interactive_mode=spec.get("interactiveMode", "IfAvailable"),
            provide_cluster_info=bool(spec.get("provideClusterInfo")),
            install_hint=spec.get("installHint", ""),
        )


class ExecCredentialPlugin:
    """Runs an exec plugin and caches the credential it issues.

    Thread-safe: a single lock serializes plugin runs so a burst of
    401-triggered refreshes from worker threads runs the (potentially
    slow — it may hit a cloud metadata server) plugin once.
    """

    def __init__(
        self,
        spec: ExecPluginSpec,
        cluster_info: Optional[dict] = None,
        run_timeout_seconds: float = 60.0,
    ) -> None:
        if spec.interactive_mode == "Always":
            raise ExecCredentialError(
                f"exec plugin {spec.command!r} requires interactiveMode "
                "Always, which this non-interactive client cannot satisfy"
                + (f" ({spec.install_hint})" if spec.install_hint else "")
            )
        self.spec = spec
        self.cluster_info = cluster_info
        self.run_timeout_seconds = run_timeout_seconds
        self._lock = threading.Lock()
        self._cached: Optional[ExecCredential] = None
        #: Monotonic count of plugin issuances — the client compares this
        #: to know when to rebuild its TLS context for rotated client
        #: certs, and passes it back as *observed_generation* to dedupe
        #: bursts of 401-forced refreshes (tests also use it to assert
        #: caching).
        self.generation = 0
        self._materialized: List[str] = []
        _LIVE_PLUGINS.add(self)

    # ---------------------------------------------------------------- public
    def credential(
        self,
        force_refresh: bool = False,
        observed_generation: Optional[int] = None,
    ) -> ExecCredential:
        """The current credential; runs the plugin on first use, after
        expiry, or when *force_refresh* (the 401 path).

        *observed_generation* dedupes forced refreshes: a caller whose
        request was 401-rejected passes the generation it sent with; if
        another thread already refreshed past it, the cached credential
        is returned instead of re-running the plugin — so a burst of
        N workers hitting a rotation runs the (possibly slow, metadata-
        server-bound) plugin once, not N times (client-go's dedup)."""
        with self._lock:
            if self._cached is not None and not self._cached.expired():
                if not force_refresh:
                    return self._cached
                if (
                    observed_generation is not None
                    and self.generation > observed_generation
                ):
                    return self._cached  # a peer already refreshed
            self._cached = self._issue()
            self.generation += 1
            return self._cached

    # --------------------------------------------------------------- plumbing
    def _issue(self) -> ExecCredential:
        env = dict(os.environ)
        for pair in self.spec.env:
            name = pair.get("name")
            if name:
                env[name] = pair.get("value", "")
        if self.spec.provide_cluster_info and self.cluster_info is not None:
            env["KUBERNETES_EXEC_INFO"] = json.dumps(
                {
                    "apiVersion": self.spec.api_version,
                    "kind": "ExecCredential",
                    "spec": {
                        "cluster": self.cluster_info,
                        "interactive": False,
                    },
                }
            )
        try:
            proc = subprocess.run(
                [self.spec.command, *self.spec.args],
                env=env,
                capture_output=True,
                text=True,
                timeout=self.run_timeout_seconds,
                check=False,
            )
        except FileNotFoundError as err:
            hint = (
                f" ({self.spec.install_hint})" if self.spec.install_hint else ""
            )
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} not found{hint}"
            ) from err
        except subprocess.TimeoutExpired as err:
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} timed out after "
                f"{self.run_timeout_seconds}s"
            ) from err
        if proc.returncode != 0:
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} failed "
                f"(rc={proc.returncode}): {proc.stderr.strip()[:500]}"
            )
        return self._parse_output(proc.stdout)

    def _parse_output(self, stdout: str) -> ExecCredential:
        try:
            doc = json.loads(stdout)
        except json.JSONDecodeError as err:
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} printed invalid JSON: "
                f"{err}"
            ) from err
        if not isinstance(doc, dict) or doc.get("kind") != "ExecCredential":
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} did not print an "
                f"ExecCredential (got kind={doc.get('kind') if isinstance(doc, dict) else type(doc).__name__!r})"
            )
        got_version = doc.get("apiVersion", "")
        if got_version != self.spec.api_version:
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} returned apiVersion "
                f"{got_version!r}, kubeconfig expects {self.spec.api_version!r}"
            )
        status = doc.get("status") or {}
        token = status.get("token")
        cert_pem = status.get("clientCertificateData")
        key_pem = status.get("clientKeyData")
        if not token and not (cert_pem and key_pem):
            raise ExecCredentialError(
                f"exec plugin {self.spec.command!r} returned neither a "
                "token nor a client certificate pair"
            )
        cred = ExecCredential(token=token)
        if cert_pem and key_pem:
            cred.client_cert_file = self._write_pem(cert_pem)
            cred.client_key_file = self._write_pem(key_pem)
        stamp = status.get("expirationTimestamp")
        if stamp:
            cred.expiration = _parse_rfc3339(stamp)
        return cred

    def _write_pem(self, pem: str) -> str:
        # ExecCredential cert data is PEM text (NOT base64-of-DER like
        # kubeconfig *-data fields)
        tmp = tempfile.NamedTemporaryFile(
            delete=False, suffix=".pem", mode="w", encoding="utf-8"
        )
        tmp.write(pem)
        tmp.close()
        self._materialized.append(tmp.name)
        return tmp.name

    def cleanup(self) -> None:
        """Remove materialized key material (called from client close /
        atexit)."""
        with self._lock:
            for path in self._materialized:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._materialized.clear()

"""The port's Kubernetes client and apiserver facade: held watch
streams, restarts, pagination, throttling, fairness, filtered watches,
and the client's configuration and error edges.

The classes of ``tests/test_client_contract.py`` from ``TestHeldWatchStreams`` on, as cases of the
same names, run on the port's :class:`KubeApiClient`, :class:`ApiServerFacade`
and :class:`InMemoryCluster`, in the port's vocabulary.  The tests that
drive the controller are in ``tests/test_torch_client_contract_operator.py``.  Every client a test makes is closed when it ends
(``test_torch_vocab.close_every_client``): its held watch threads are
joined (and must have stopped) and its pooled sockets closed.  The JAX and the port's HTTP stacks are held to each other on one
seeded operation sequence in ``tests/test_torch_http_parity.py``.
"""



import threading


import time


from http.client import IncompleteRead


import pytest


from k8s_operator_libs_tpu_torch.cluster import (
    ApiServerFacade,
    ConflictError,
    ExecCredentialError,
    ExpiredError,
    InMemoryCluster,
    KubeApiClient,
    KubeConfig,
    NotFoundError,
    TooManyRequestsError,
)


from k8s_operator_libs_tpu_torch.cluster.objects import make_node, make_pod


from test_torch_vocab import close_every_client, port_globals  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("port_globals", "close_every_client")


def _wait_until(pred, timeout=10.0, what="condition"):
    """Wait on *pred* (polled) instead of sleeping a fixed time."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _streams_open(client):
    """True once every held watcher has sent its watch request."""
    watchers = list(client._held_watchers)
    return bool(watchers) and all(w._sock is not None for w in watchers)


def _join_all(threads, timeout=30.0):
    for t in threads:
        t.join(timeout)
    assert not [t.name for t in threads if t.is_alive()], "threads still running"


@pytest.fixture(params=["inmem", "http"])
def backend(request):
    """Yields (client, store): the ClusterClient under test plus the
    backing store (for journal-cap manipulation in the 410 test)."""
    store = InMemoryCluster()
    if request.param == "inmem":
        yield store, store
        return
    facade = ApiServerFacade(store).start()
    client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
    try:
        yield client, store
    finally:
        facade.stop()


class TestHeldWatchStreams:
    """held watch streams — a long watch per kind
    pushed by the server (the controller-runtime informer pattern)
    instead of per-poll bounded watches."""

    def _client(self, facade, hold=3.0, kinds=("Node",)):
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        client.start_held_watches(kinds, hold_seconds=hold)
        return client

    def _drain_until(self, client, seq, pred, timeout=10.0):
        """Poll events_since until pred(all_events) or timeout.  A 410
        mid-drain is handled the way a controller does — note it, relist
        conceptually, keep consuming."""
        collected = []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            client.wait_for_held_event(seq, timeout=0.25)
            try:
                batch = client.events_since(
                    seq, kind=tuple(client._held_kinds)
                )
            except ExpiredError:
                continue
            collected.extend(batch)
            if batch:
                seq = max(seq, max(e.seq for e in batch))
            if pred(collected):
                return collected, seq
        raise AssertionError(f"condition not met; got {collected}")

    def test_stream_pushes_events_without_bounded_polls(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = self._client(facade)
            try:
                # the bounded-poll path must never run in held mode
                def boom(info, query):
                    raise AssertionError("bounded poll used in held mode")

                client._request_watch = boom
                seq = client.journal_seq()
                client.create(make_node("n1"))
                events, _ = self._drain_until(
                    client,
                    seq,
                    lambda evs: any(e.type == "Added" for e in evs),
                )
                added = [e for e in events if e.type == "Added"]
                assert added[0].new["metadata"]["name"] == "n1"
            finally:
                client.stop_held_watches()

    def test_old_synthesis_and_delete_over_stream(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = self._client(facade)
            try:
                seq = client.journal_seq()
                client.create(make_node("n1"))
                client.patch(
                    "Node", "n1", {"metadata": {"labels": {"x": "1"}}}
                )
                client.delete("Node", "n1")
                events, _ = self._drain_until(
                    client,
                    seq,
                    lambda evs: any(e.type == "Deleted" for e in evs),
                )
                types = [e.type for e in events]
                assert types == ["Added", "Modified", "Deleted"]
                modified = events[1]
                assert modified.old is not None  # informer old-synthesis
                assert modified.new["metadata"]["labels"]["x"] == "1"
                assert events[2].old is not None and events[2].new is None
            finally:
                client.stop_held_watches()

    def test_journal_expiry_surfaces_410_then_recovers(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = self._client(facade, hold=2.5)
            try:
                seq = client.journal_seq()
                # let the Node stream establish, then emulate a partition:
                # the journal rolls past the client's resume position
                # while its stream is down
                _wait_until(lambda: _streams_open(client), what="the Node stream")
                store._journal_cap = 5
                for i in range(12):
                    client.create(make_pod(f"p{i}", "ml", "n1"))
                with client._last_seen_lock:
                    client._kind_bookmarks["Node"] = 1  # below the floor
                watcher = client._held_watchers[0]
                with watcher._conn_lock:
                    sock = watcher._sock
                if sock is not None:
                    import socket as _socket

                    sock.shutdown(_socket.SHUT_RDWR)
                # the reconnecting stream hits 410; the next drain raises
                deadline = time.monotonic() + 15.0
                saw_expired = False
                while time.monotonic() < deadline:
                    try:
                        client.events_since(seq, kind=("Node",))
                    except ExpiredError:
                        saw_expired = True
                        break
                    time.sleep(0.1)
                assert saw_expired
                # ...and the stream recovers.  A write during a reset
                # window becomes relist state, not an event (informer
                # semantics), and residual churn can 410 the stream more
                # than once — so recover the way a controller does: keep
                # writing fresh nodes and tolerate expiries until one
                # arrives as a streamed event.
                got_event = False
                deadline = time.monotonic() + 20.0
                i = 0
                while time.monotonic() < deadline and not got_event:
                    name = f"n-after-{i}"
                    i += 1
                    head_before = client.journal_seq()
                    client.create(make_node(name))
                    settle = time.monotonic() + 1.5
                    while time.monotonic() < settle:
                        client.wait_for_held_event(head_before, timeout=0.25)
                        try:
                            evs = client.events_since(
                                head_before, kind=("Node",)
                            )
                        except ExpiredError:
                            continue
                        if any(
                            (e.new or {}).get("metadata", {}).get("name")
                            == name
                            for e in evs
                        ):
                            got_event = True
                            break
                assert got_event
            finally:
                client.stop_held_watches()

    def test_stop_joins_quickly(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = self._client(facade, hold=30.0)
            _wait_until(lambda: _streams_open(client), what="the stream")  # established and holding
            t0 = time.monotonic()
            client.stop_held_watches()
            assert time.monotonic() - t0 < 5.0
            assert client._held_kinds == frozenset()


class TestStrategicMergePatch:
    """strategic merge patch — list-of-maps fields
    merge by their Kubernetes patchMergeKey instead of being replaced
    wholesale (RFC 7386), on BOTH backends via the content type."""

    def _pod(self, client):
        pod = make_pod("p1", "ml", "n1")
        pod["spec"]["containers"] = [
            {"name": "main", "image": "app:v1", "env": [{"name": "A", "value": "1"}]},
            {"name": "sidecar", "image": "side:v1"},
        ]
        client.create(pod)

    def test_keyed_list_merges_by_name(self, backend):
        client, _ = backend
        self._pod(client)
        patched = client.patch(
            "Pod",
            "p1",
            {"spec": {"containers": [{"name": "main", "image": "app:v2"}]}},
            "ml",
            patch_type="strategic",
        )
        containers = {c["name"]: c for c in patched["spec"]["containers"]}
        assert containers["main"]["image"] == "app:v2"
        assert containers["main"]["env"] == [{"name": "A", "value": "1"}]
        assert containers["sidecar"]["image"] == "side:v1"  # untouched

    def test_merge_patch_replaces_the_whole_list(self, backend):
        """The RFC 7386 behavior the strategic type exists to avoid."""
        client, _ = backend
        self._pod(client)
        patched = client.patch(
            "Pod",
            "p1",
            {"spec": {"containers": [{"name": "main", "image": "app:v2"}]}},
            "ml",
            patch_type="merge",
        )
        assert [c["name"] for c in patched["spec"]["containers"]] == ["main"]

    def test_patch_delete_directive_removes_element(self, backend):
        client, _ = backend
        self._pod(client)
        patched = client.patch(
            "Pod",
            "p1",
            {
                "spec": {
                    "containers": [{"name": "sidecar", "$patch": "delete"}]
                }
            },
            "ml",
            patch_type="strategic",
        )
        assert [c["name"] for c in patched["spec"]["containers"]] == ["main"]

    def test_node_taints_merge_by_key(self, backend):
        client, _ = backend
        node = make_node("n1")
        node["spec"]["taints"] = [
            {"key": "tpu", "effect": "NoSchedule", "value": "v5"}
        ]
        client.create(node)
        patched = client.patch(
            "Node",
            "n1",
            {
                "spec": {
                    "taints": [
                        {"key": "maintenance", "effect": "NoExecute"}
                    ]
                }
            },
            patch_type="strategic",
        )
        keys = sorted(t["key"] for t in patched["spec"]["taints"])
        assert keys == ["maintenance", "tpu"]  # appended, not replaced

    def test_unkeyed_list_stays_atomic(self, backend):
        client, _ = backend
        node = make_node("n1")
        node["spec"]["podCIDRs"] = ["10.0.0.0/24", "10.0.1.0/24"]
        client.create(node)
        patched = client.patch(
            "Node",
            "n1",
            {"spec": {"podCIDRs": ["10.9.0.0/24"]}},
            patch_type="strategic",
        )
        assert patched["spec"]["podCIDRs"] == ["10.9.0.0/24"]

    def test_replace_directive_on_keyed_list(self, backend):
        client, _ = backend
        self._pod(client)
        patched = client.patch(
            "Pod",
            "p1",
            {
                "spec": {
                    "containers": [
                        {"$patch": "replace"},
                        {"name": "only", "image": "x:1"},
                    ]
                }
            },
            "ml",
            patch_type="strategic",
        )
        assert [c["name"] for c in patched["spec"]["containers"]] == ["only"]

    def test_unsupported_directive_rejected(self, backend):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        client, _ = backend
        self._pod(client)
        with pytest.raises(BadRequestError):
            client.patch(
                "Pod",
                "p1",
                {"spec": {"$setElementOrder/containers": []}},
                "ml",
                patch_type="strategic",
            )

    def test_rv_guard_applies_to_strategic_patches(self, backend):
        client, _ = backend
        self._pod(client)
        stale = client.get("Pod", "p1", "ml")
        client.patch(
            "Pod", "p1", {"metadata": {"labels": {"x": "1"}}}, "ml"
        )
        with pytest.raises(ConflictError):
            client.patch(
                "Pod",
                "p1",
                {
                    "metadata": {
                        "resourceVersion": stale["metadata"]["resourceVersion"]
                    },
                    "spec": {"containers": [{"name": "main", "image": "z"}]},
                },
                "ml",
                patch_type="strategic",
            )

    def test_patch_merge_directive_stripped(self, backend):
        """Review regression: '$patch': 'merge' (the explicit default) is
        applied, never stored as a literal key."""
        client, _ = backend
        self._pod(client)
        patched = client.patch(
            "Pod",
            "p1",
            {
                "spec": {
                    "containers": [
                        {"name": "main", "$patch": "merge", "image": "a:2"}
                    ]
                }
            },
            "ml",
            patch_type="strategic",
        )
        main = [
            c for c in patched["spec"]["containers"] if c["name"] == "main"
        ][0]
        assert main["image"] == "a:2"
        assert "$patch" not in main

    def test_patch_delete_map_key(self, backend):
        client, _ = backend
        node = make_node("n1")
        node["spec"]["providerID"] = "x"
        node["metadata"]["labels"]["keep"] = "1"
        client.create(node)
        patched = client.patch(
            "Node",
            "n1",
            {"metadata": {"labels": {"$patch": "delete"}}},
            patch_type="strategic",
        )
        assert "labels" not in patched["metadata"]
        assert patched["spec"]["providerID"] == "x"

    def test_unknown_patch_directive_rejected(self, backend):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        client, _ = backend
        self._pod(client)
        with pytest.raises(BadRequestError):
            client.patch(
                "Pod",
                "p1",
                {"spec": {"containers": [{"name": "main", "$patch": "explode"}]}},
                "ml",
                patch_type="strategic",
            )
        with pytest.raises(BadRequestError):
            client.patch(
                "Pod",
                "p1",
                {"spec": {"nodeSelector": {"$patch": "explode"}}},
                "ml",
                patch_type="strategic",
            )

    def test_root_patch_delete_rejected(self, backend):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        client, _ = backend
        client.create(make_node("n1"))
        with pytest.raises(BadRequestError):
            client.patch(
                "Node", "n1", {"$patch": "delete"}, patch_type="strategic"
            )
        # the directive never reached the store as a literal key
        assert "$patch" not in client.get("Node", "n1")


class TestHeldMixedRequests:
    """Mixed held+polled events_since requests."""

    def test_poll_410_requeues_popped_held_events(self):
        """Review regression: when the polled side of a mixed request
        410s, the already-popped held events must return to the queue —
        pop-once must not become zero-times."""
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client.start_held_watches(("Node",), hold_seconds=3.0)
            try:
                seq = client.journal_seq()
                client.create(make_node("n1"))
                # wait until the stream has pushed the Added into the queue
                assert client.wait_for_held_event(timeout=5.0)
                # make the DaemonSet bounded poll expire: stale bookmark
                # under a tiny journal window
                store._journal_cap = 4
                for i in range(8):
                    client.create(make_pod(f"p{i}", "ml", "nX"))
                with client._last_seen_lock:
                    client._kind_bookmarks["DaemonSet"] = 1
                    client._seeded_kinds.add("DaemonSet")
                with pytest.raises(ExpiredError):
                    client.events_since(seq, kind=("Node", "DaemonSet"))
                # the popped Node event is back and still delivered
                events = client.events_since(seq, kind=("Node",))
                names = [
                    (e.new or {}).get("metadata", {}).get("name")
                    for e in events
                    if e.type == "Added"
                ]
                assert "n1" in names
            finally:
                client.stop_held_watches()


class TestHeldWatchApiserverRestart:
    """Chaos: the apiserver dies mid-stream and comes back — the held
    watchers must ride out the outage and resume delivering events."""

    def test_stream_survives_apiserver_restart(self):
        from urllib.parse import urlparse

        store = InMemoryCluster()
        facade = ApiServerFacade(store).start()
        port = urlparse(facade.url).port
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        client.start_held_watches(("Node",), hold_seconds=3.0)
        try:
            client.create(make_node("n-before"))
            assert client.wait_for_held_event(timeout=5.0)
            events = client.events_since(0, kind=("Node",))
            assert any(
                (e.new or {}).get("metadata", {}).get("name") == "n-before"
                for e in events
            )

            # apiserver goes down; the store (etcd) survives
            facade.stop()
            time.sleep(0.3)  # watcher hits connection errors, retries
            store.create(make_node("n-during"))  # write lands in "etcd"

            # apiserver returns on the SAME port
            facade = ApiServerFacade(store, port=port).start()

            # the stream reconnects; n-during arrives — either as a
            # streamed frame or (if the watcher had to reseed) it is
            # already in last_seen and a fresh write proves the stream
            deadline = time.monotonic() + 15.0
            seen = set()
            while time.monotonic() < deadline:
                client.wait_for_held_event(timeout=0.25)
                try:
                    batch = client.events_since(0, kind=("Node",))
                except ExpiredError:
                    continue
                seen.update(
                    (e.new or {}).get("metadata", {}).get("name")
                    for e in batch
                )
                if "n-during" in seen:
                    break
                # keep a fresh write in flight so recovery is observable
                # even if n-during was folded into a reseed list
                if any(
                    isinstance(n, str) and n.startswith("n-after-")
                    for n in seen
                ):
                    break  # a post-outage write streamed through
                name = f"n-after-{int((time.monotonic() % 100) * 10)}"
                try:
                    client.create(make_node(name))
                except Exception:
                    pass
                time.sleep(0.2)
            assert seen, "no events after apiserver restart"
            # the definitive check: a post-restart write streams through
            client.create(make_node("n-final"))
            deadline = time.monotonic() + 10.0
            got_final = False
            while time.monotonic() < deadline and not got_final:
                client.wait_for_held_event(timeout=0.25)
                try:
                    batch = client.events_since(0, kind=("Node",))
                except ExpiredError:
                    continue
                got_final = any(
                    (e.new or {}).get("metadata", {}).get("name") == "n-final"
                    for e in batch
                )
            assert got_final
        finally:
            client.stop_held_watches()
            facade.stop()

    def test_first_write_after_start_is_never_lost(self):
        """Regression: start_held_watches seeds bookmarks synchronously,
        so a create issued the instant it returns is strictly past the
        bookmark and must be delivered (was a race: the watcher thread's
        own seed list could absorb the write)."""
        for _ in range(5):
            store = InMemoryCluster()
            facade = ApiServerFacade(store).start()
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client.start_held_watches(("Node",), hold_seconds=3.0)
            try:
                client.create(make_node("n-first"))
                assert client.wait_for_held_event(timeout=5.0)
                events = client.events_since(0, kind=("Node",))
                assert any(
                    (e.new or {}).get("metadata", {}).get("name") == "n-first"
                    for e in events
                )
            finally:
                client.stop_held_watches()
                facade.stop()

    @pytest.mark.parametrize(
        "injected",
        [
            ConnectionRefusedError("injected seed failure"),
            IncompleteRead(b""),
            ExecCredentialError("auth helper transiently failing"),
        ],
        ids=["oserror", "httpexception", "execauth"],
    )
    def test_seed_failure_degrades_to_full_replay(self, injected):
        """A seed list that fails during start_held_watches must neither
        crash startup nor reintroduce the lost-first-write race: the
        bookmark is pinned to 0, the stream replays the journal, and the
        caller's first write still arrives."""
        store = InMemoryCluster()
        facade = ApiServerFacade(store).start()
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        real_list = client.list
        calls = {"n": 0}

        def failing_first_list(kind, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise injected
            return real_list(kind, *args, **kwargs)

        client.list = failing_first_list  # type: ignore[method-assign]
        client.start_held_watches(("Node",), hold_seconds=3.0)  # no raise
        try:
            assert calls["n"] >= 1, "seed list was not attempted"
            client.create(make_node("n-after-seed-fail"))
            assert client.wait_for_held_event(timeout=5.0)
            events = client.events_since(0, kind=("Node",))
            assert any(
                (e.new or {}).get("metadata", {}).get("name")
                == "n-after-seed-fail"
                for e in events
            )
        finally:
            client.stop_held_watches()
            facade.stop()


class TestChunkedListPagination:
    """Chunked LIST (``limit``/``continue``) — the client-go pager
    semantics the reference inherits via controller-runtime's paginated
    cache fills (go.mod:11-16).  Server-side snapshot consistency,
    idempotent continue tokens, 410 expiry, and the client pager's
    transparent drain + restart-on-410."""

    def test_snapshot_consistent_across_page_boundary_writes(self):
        store = InMemoryCluster()
        for i in range(25):
            store.create(make_node(f"n{i:03d}"))
        p1 = store.list_page("Node", limit=10)
        assert len(p1.items) == 10
        assert p1.remaining_item_count == 15
        # Writes landing BETWEEN pages must not leak into later pages:
        # the list stays consistent at the first page's revision.
        store.delete("Node", "n015")
        store.create(make_node("zz-new"))
        p2 = store.list_page("Node", continue_token=p1.continue_token, limit=10)
        names2 = [o["metadata"]["name"] for o in p2.items]
        assert "n015" in names2
        assert p2.resource_version == p1.resource_version
        p3 = store.list_page("Node", continue_token=p2.continue_token, limit=10)
        assert p3.continue_token == ""
        assert "zz-new" not in [o["metadata"]["name"] for o in p3.items]
        # A FRESH list sees the post-write world.
        fresh = store.list_page("Node", limit=100)
        fresh_names = [o["metadata"]["name"] for o in fresh.items]
        assert "zz-new" in fresh_names and "n015" not in fresh_names

    def test_continue_token_is_idempotent(self):
        """client-go retries a page on transport error before falling
        back to a relist — the same token must re-serve the same page."""
        store = InMemoryCluster()
        for i in range(9):
            store.create(make_node(f"n{i}"))
        p1 = store.list_page("Node", limit=4)
        a = store.list_page("Node", continue_token=p1.continue_token, limit=4)
        b = store.list_page("Node", continue_token=p1.continue_token, limit=4)
        assert [o["metadata"]["name"] for o in a.items] == [
            o["metadata"]["name"] for o in b.items
        ]
        assert a.continue_token == b.continue_token

    def test_continue_token_expires_with_410(self):
        store = InMemoryCluster()
        store._journal_cap = 5
        for i in range(8):
            store.create(make_node(f"n{i}"))
        p1 = store.list_page("Node", limit=3)
        # Roll the journal past the snapshot's revision (compaction).
        for i in range(10):
            store.create(make_node(f"late{i}"))
        with pytest.raises(ExpiredError):
            store.list_page("Node", continue_token=p1.continue_token, limit=3)

    def test_malformed_and_unknown_tokens_are_410(self):
        store = InMemoryCluster()
        store.create(make_node("n1"))
        with pytest.raises(ExpiredError):
            store.list_page("Node", continue_token="nonsense.x")
        with pytest.raises(ExpiredError):
            store.list_page("Node", continue_token="deadbeef.0")

    def test_resource_version_match_semantics(self):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        store = InMemoryCluster()
        store.create(make_node("n1"))
        current = str(store.journal_seq())
        # Exact at the current revision: served.
        page = store.list_page(
            "Node", resource_version=current, resource_version_match="Exact"
        )
        assert len(page.items) == 1
        store.create(make_node("n2"))
        # Exact at a stale revision: 410 (compacted).
        with pytest.raises(ExpiredError):
            store.list_page(
                "Node",
                resource_version=current,
                resource_version_match="Exact",
            )
        # NotOlderThan a past revision: latest qualifies.
        page = store.list_page(
            "Node",
            resource_version=current,
            resource_version_match="NotOlderThan",
        )
        assert len(page.items) == 2
        # A FUTURE revision is rejected loudly.
        with pytest.raises(BadRequestError):
            store.list_page("Node", resource_version="999999")
        # resourceVersion cannot ride a continue.
        p1 = store.list_page("Node", limit=1)
        with pytest.raises(BadRequestError):
            store.list_page(
                "Node",
                continue_token=p1.continue_token,
                resource_version=current,
            )

    def test_client_pager_drains_server_enforced_pages(self):
        """The facade caps every response at max_list_page, so the
        client's pager is on the hot path whether or not the caller
        asked for chunking — and list() still returns the whole sorted
        collection."""
        store = InMemoryCluster()
        for i in range(25):
            store.create(make_node(f"n{i:03d}"))
        with ApiServerFacade(store, max_list_page=7) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            names = [n["metadata"]["name"] for n in client.list("Node")]
            assert len(names) == 25
            assert names == sorted(names)
            # Server-enforced pagination with client chunking off.
            client.list_page_size = 0
            assert len(client.list("Node")) == 25

    def test_client_pager_4096_nodes_limit_500(self):
        """The VERDICT acceptance probe: a 4,096-node collection over
        HTTP with limit=500 enforced server-side drains in 9 pages."""
        store = InMemoryCluster()
        for i in range(4096):
            store.create(make_node(f"node-{i:05d}"))
        with ApiServerFacade(store, max_list_page=500) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=30.0)
            nodes = client.list("Node")
            assert len(nodes) == 4096
            names = [n["metadata"]["name"] for n in nodes]
            assert names == sorted(names)

    def test_client_pager_restarts_on_mid_pagination_410(self, monkeypatch):
        """A continue token expiring mid-drain (server compacted the
        snapshot) triggers ONE full restart — pages from the dead
        snapshot are discarded, never mixed into the result."""
        store = InMemoryCluster()
        for i in range(20):
            store.create(make_node(f"n{i:02d}"))
        real = store._serve_continue
        failed = {"n": 0}

        def flaky(token, limit, request):
            if failed["n"] == 0:
                failed["n"] += 1
                raise ExpiredError("snapshot compacted (injected)")
            return real(token, limit, request)

        monkeypatch.setattr(store, "_serve_continue", flaky)
        with ApiServerFacade(store, max_list_page=6) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            nodes = client.list("Node")
        assert failed["n"] == 1
        assert len(nodes) == 20

    def test_informer_snapshot_rides_paginated_lists(self):
        """snapshot() (the InformerCache seed) goes through list(), so a
        page-capped server still yields a complete seed."""
        store = InMemoryCluster()
        for i in range(23):
            store.create(make_node(f"n{i:02d}"))
        with ApiServerFacade(store, max_list_page=5) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            snap = client.snapshot(kinds=("Node",))
            assert len(snap) == 23

    def test_continue_token_bound_to_its_collection(self):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        store = InMemoryCluster()
        for i in range(6):
            store.create(make_node(f"n{i}"))
            store.create(make_pod(f"p{i}", "ml", f"n{i}"))
        p1 = store.list_page("Node", limit=2)
        with pytest.raises(BadRequestError):
            store.list_page("Pod", continue_token=p1.continue_token, limit=2)
        with pytest.raises(BadRequestError):
            store.list_page(
                "Node",
                label_selector="pool=tpu",
                continue_token=p1.continue_token,
                limit=2,
            )

    def test_drained_snapshot_is_dropped_final_page_not_replayable(self):
        store = InMemoryCluster()
        for i in range(5):
            store.create(make_node(f"n{i}"))
        p1 = store.list_page("Node", limit=3)
        p2 = store.list_page("Node", continue_token=p1.continue_token, limit=3)
        assert p2.continue_token == ""
        assert not store._page_snapshots  # drained → dropped eagerly
        with pytest.raises(ExpiredError):  # replaying the final page 410s
            store.list_page("Node", continue_token=p1.continue_token, limit=3)

    def test_invalid_resource_version_match_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        store = InMemoryCluster()
        store.create(make_node("n1"))
        with pytest.raises(BadRequestError):
            store.list_page(
                "Node", resource_version="1", resource_version_match="exact"
            )
        with pytest.raises(BadRequestError):
            store.list_page("Node", resource_version_match="Exact")

    def test_remaining_item_count_omitted_with_selectors(self):
        store = InMemoryCluster()
        for i in range(8):
            store.create(make_node(f"n{i}", labels={"pool": "tpu"}))
        plain = store.list_page("Node", limit=3)
        assert plain.remaining_item_count == 5
        selected = store.list_page("Node", label_selector="pool=tpu", limit=3)
        assert selected.remaining_item_count is None

    def test_rv_zero_with_exact_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        store = InMemoryCluster()
        store.create(make_node("n1"))
        with pytest.raises(BadRequestError):
            store.list_page(
                "Node", resource_version="0", resource_version_match="Exact"
            )

    def test_negative_offset_token_rejected(self):
        store = InMemoryCluster()
        for i in range(6):
            store.create(make_node(f"n{i}"))
        p1 = store.list_page("Node", limit=2)
        handle = p1.continue_token.split(".")[0]
        with pytest.raises(ExpiredError):
            store.list_page("Node", continue_token=f"{handle}.-3", limit=2)

    def test_active_pagination_survives_orphan_snapshot_churn(self):
        """LRU touch: a draining pagination outlives a flood of
        abandoned snapshots that would otherwise FIFO-evict it."""
        store = InMemoryCluster()
        for i in range(10):
            store.create(make_node(f"n{i}"))
        page = store.list_page("Node", limit=2)
        for round_ in range(3):
            # Flood: nearly fill the table with orphans, then touch the
            # active token — it must survive every flood.
            for _ in range(store._page_snapshot_cap - 2):
                store.list_page("Node", limit=1)
            page = store.list_page(
                "Node", continue_token=page.continue_token, limit=2
            )
            assert page.items, f"active snapshot evicted on round {round_}"

    def test_rv_probe_creates_no_server_snapshots(self):
        """journal_seq (polled every 50 ms by wait_for_seq) must not
        deposit orphan continue snapshots on a page-capped server."""
        store = InMemoryCluster()
        for i in range(30):
            store.create(make_node(f"n{i}"))
        with ApiServerFacade(store, max_list_page=5) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            assert client.journal_seq() == 30
            client.wait_for_seq(5, timeout=0.2)
            assert len(store._page_snapshots) == 0


class TestStrategicMergeLoudness:
    """ADVICE r3 / VERDICT task 9: atomically replacing an unregistered
    object-list must be LOUD — a metric per patch and one warning per
    field — and the key table covers the real struct-tag keys for
    served kinds."""

    def test_unregistered_object_list_trips_counter_and_warns_once(
        self, caplog
    ):
        import logging as _logging

        from k8s_operator_libs_tpu_torch import metrics as metrics_mod
        from k8s_operator_libs_tpu_torch.cluster import strategicmerge

        registry = metrics_mod.MetricsRegistry()
        prev = metrics_mod.set_default_registry(registry)
        strategicmerge._atomic_warned.discard(("*", "spec.widgets"))
        try:
            target = {"spec": {"widgets": [{"id": 1}, {"id": 2}]}}
            patch = {"spec": {"widgets": [{"id": 3}]}}
            with caplog.at_level(
                _logging.WARNING, logger=strategicmerge.__name__
            ):
                out = strategicmerge.strategic_merge(target, patch)
                assert out["spec"]["widgets"] == [{"id": 3}]  # atomic
                strategicmerge.strategic_merge(target, patch)  # again
            counter = registry.counter(
                "strategic_merge_atomic_list_patches_total",
                "",
                ("kind", "path"),
            )
            assert counter.value("*", "spec.widgets") == 2  # every patch
            warns = [
                r for r in caplog.records if "spec.widgets" in r.getMessage()
            ]
            assert len(warns) == 1  # but one warning
        finally:
            metrics_mod.set_default_registry(prev)

    def test_primitive_lists_replace_silently(self, caplog):
        """Primitive lists (finalizers, args) are atomic in real k8s too
        — no warning noise for them."""
        import logging as _logging

        from k8s_operator_libs_tpu_torch.cluster import strategicmerge

        with caplog.at_level(_logging.WARNING, logger=strategicmerge.__name__):
            out = strategicmerge.strategic_merge(
                {"metadata": {"finalizers": ["a"]}},
                {"metadata": {"finalizers": ["b"]}},
            )
        assert out["metadata"]["finalizers"] == ["b"]
        assert not caplog.records

    def test_struct_tag_keys_for_served_kinds(self):
        """Spot-check the extended table against upstream struct tags."""
        from k8s_operator_libs_tpu_torch.cluster.strategicmerge import _merge_key_for

        assert _merge_key_for("*", "metadata.ownerReferences") == "uid"
        assert _merge_key_for("*", "spec.hostAliases") == "ip"
        assert (
            _merge_key_for("*", "spec.topologySpreadConstraints")
            == "topologyKey"
        )
        assert (
            _merge_key_for("*", "spec.containers.volumeDevices")
            == "devicePath"
        )
        assert _merge_key_for("*", "status.addresses") == "type"
        assert (
            _merge_key_for("*", "spec.template.spec.imagePullSecrets")
            == "name"
        )
        # tolerations carries NO patchMergeKey upstream: atomic is right
        assert _merge_key_for("*", "spec.tolerations") is None

    def test_owner_references_keyed_merge(self):
        from k8s_operator_libs_tpu_torch.cluster.strategicmerge import strategic_merge

        target = {
            "metadata": {
                "ownerReferences": [
                    {"uid": "a", "name": "one", "controller": True},
                    {"uid": "b", "name": "two"},
                ]
            }
        }
        patch = {
            "metadata": {
                "ownerReferences": [{"uid": "b", "blockOwnerDeletion": True}]
            }
        }
        out = strategic_merge(target, patch)
        refs = {r["uid"]: r for r in out["metadata"]["ownerReferences"]}
        assert len(refs) == 2
        assert refs["b"]["name"] == "two"
        assert refs["b"]["blockOwnerDeletion"] is True
        assert refs["a"]["controller"] is True

    def test_explicit_replace_of_unregistered_list_is_silent(self, caplog):
        """[{'$patch': 'replace'}, ...] is the documented intentional
        form — no metric, no warning."""
        import logging as _logging

        from k8s_operator_libs_tpu_torch import metrics as metrics_mod
        from k8s_operator_libs_tpu_torch.cluster import strategicmerge

        registry = metrics_mod.MetricsRegistry()
        prev = metrics_mod.set_default_registry(registry)
        try:
            with caplog.at_level(
                _logging.WARNING, logger=strategicmerge.__name__
            ):
                out = strategicmerge.strategic_merge(
                    {"spec": {"widgets": [{"id": 1}]}},
                    {"spec": {"widgets": [{"$patch": "replace"}, {"id": 9}]}},
                )
            assert out["spec"]["widgets"] == [{"id": 9}]
            counter = registry.counter(
                "strategic_merge_atomic_list_patches_total",
                "",
                ("kind", "path"),
            )
            assert counter.value("*", "spec.widgets") == 0
            assert not caplog.records
        finally:
            metrics_mod.set_default_registry(prev)


class TestPerKindDeliveryFloors:
    """VERDICT r3 task 8: the bounded-poll path must never let one
    kind's resourceVersion churn decide whether another kind's frame is
    delivered — floors are per-kind, pinned when the kind's watch is
    established."""

    def _client(self, store):
        facade = ApiServerFacade(store).start()
        return facade, KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)

    def test_late_arriving_kind_not_swallowed_by_global_cursor(self):
        """The regression the global filter had: a Pod frame whose RV is
        below a cursor advanced by Node churn must still be delivered
        the first time the Pod kind is polled for it."""
        store = InMemoryCluster()
        store.create(make_node("n1"))
        store.create(make_pod("p1", "ml", "n1"))
        facade, client = self._client(store)
        try:
            # establish watches for both kinds at cursor 0
            client.events_since(0, kind=("Node", "Pod"))
            # a Pod write (low RV) followed by Node churn (higher RVs)
            client.patch("Pod", "p1", {"metadata": {"labels": {"x": "1"}}}, "ml")
            for i in range(5):
                client.patch("Node", "n1", {"metadata": {"labels": {"i": str(i)}}})
            head = store.journal_seq()
            # a Node-only poll advances the caller's global cursor to head
            node_events = client.events_since(0, kind=("Node",))
            assert node_events, "node churn must be visible"
            # now the caller polls BOTH kinds with its advanced cursor:
            # the Pod frame's RV < head, but it was never delivered —
            # per-kind floors must deliver it
            events = client.events_since(head, kind=("Node", "Pod"))
            pod_events = [
                e for e in events if (e.new or e.old or {}).get("kind") == "Pod"
            ]
            assert pod_events, (
                "Pod frame swallowed by a cursor advanced by Node churn"
            )
            assert pod_events[0].new["metadata"]["labels"]["x"] == "1"
        finally:
            facade.stop()

    def test_no_duplicate_delivery_within_a_kind(self):
        store = InMemoryCluster()
        store.create(make_node("n1"))
        facade, client = self._client(store)
        try:
            client.events_since(0, kind=("Node",))
            client.patch("Node", "n1", {"metadata": {"labels": {"a": "1"}}})
            first = client.events_since(0, kind=("Node",))
            assert len(first) == 1
            # same cursor again: already delivered for this kind
            again = client.events_since(0, kind=("Node",))
            assert again == []
        finally:
            facade.stop()

    def test_interleaved_multi_kind_writes_per_kind_order(self):
        """Interleaved Node/Pod writes: each kind's events arrive in
        that kind's write order (per-kind positions are exact); no
        cross-kind guarantee is asserted — that is the API contract."""
        store = InMemoryCluster()
        store.create(make_node("n1"))
        store.create(make_pod("p1", "ml", "n1"))
        facade, client = self._client(store)
        try:
            client.events_since(0, kind=("Node", "Pod"))
            for i in range(4):
                client.patch(
                    "Node", "n1", {"metadata": {"labels": {"i": str(i)}}}
                )
                client.patch(
                    "Pod", "p1", {"metadata": {"labels": {"i": str(i)}}}, "ml"
                )
            events = client.events_since(0, kind=("Node", "Pod"))
            for want_kind in ("Node", "Pod"):
                ours = [
                    (e.new or {}).get("metadata", {}).get("labels", {}).get("i")
                    for e in events
                    if (e.new or e.old or {}).get("kind") == want_kind
                ]
                assert ours == ["0", "1", "2", "3"], (want_kind, ours)
        finally:
            facade.stop()

    def test_floor_resets_with_kind_state_on_410(self):
        store = InMemoryCluster()
        store._journal_cap = 5
        store.create(make_node("n1"))
        facade, client = self._client(store)
        try:
            client.events_since(0, kind=("Node",))
            for i in range(12):  # roll the journal past the bookmark
                store.create(make_node(f"extra{i}"))
            with pytest.raises(ExpiredError):
                client.events_since(0, kind=("Node",))
            assert "Node" not in client._kind_delivered
            # recovery: relist + resume delivers subsequent events
            client.list("Node")
            client.events_since(store.journal_seq(), kind=("Node",))
            client.patch("Node", "n1", {"metadata": {"labels": {"back": "1"}}})
            events = client.events_since(store.journal_seq() - 1, kind=("Node",))
            assert any(
                (e.new or {}).get("metadata", {}).get("labels", {}).get("back")
                for e in events
            )
        finally:
            facade.stop()


class TestClientSideThrottle:
    """client-go flowcontrol parity: KubeConfig(qps, burst) installs a
    token-bucket limiter every request passes through before the wire
    (rest.Config QPS/Burst; controller-runtime defaults 20/30 — the
    operator example's --qps/--burst.  Deviation: 0 = unlimited here,
    where client-go defaults to 5/10 — the simulation benches measure
    engine cost, not a self-imposed cap)."""

    def test_requests_beyond_burst_are_paced(self):
        store = InMemoryCluster()
        store.create(make_node("n1"))
        with ApiServerFacade(store) as facade:
            # qps low enough that the pacing window (0.75 s) dwarfs
            # per-request wall overhead on a loaded machine — with the
            # old 50 qps the 0.2 s window was comparable to 15 slow
            # HTTP round trips, and tokens refilled during them pushed
            # the recorded bucket wait under the assertion (flaked
            # whenever the box was busy)
            client = KubeApiClient(
                KubeConfig(server=facade.url, qps=20.0, burst=5), timeout=10.0
            )
            t0 = time.monotonic()
            for _ in range(20):
                client.get("Node", "n1")
            elapsed = time.monotonic() - t0
        # 5 ride the burst; 15 refill at 20/s => >= 0.75 s of pacing
        assert elapsed >= 0.7, f"no pacing observed ({elapsed:.3f}s)"
        assert client.throttle_waited_seconds >= 0.3

    def test_burst_rides_free(self):
        store = InMemoryCluster()
        store.create(make_node("n1"))
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(
                KubeConfig(server=facade.url, qps=10.0, burst=10), timeout=10.0
            )
            t0 = time.monotonic()
            for _ in range(8):
                client.get("Node", "n1")
            elapsed = time.monotonic() - t0
        # within burst: no sleeps — generous bound for slow CI
        assert elapsed < 1.0
        assert client.throttle_waited_seconds == 0.0

    def test_default_is_unlimited(self):
        store = InMemoryCluster()
        store.create(make_node("n1"))
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            for _ in range(20):
                client.get("Node", "n1")
        assert client.throttle_waited_seconds == 0.0

    def test_throttle_is_thread_safe_and_fair(self):
        """Concurrent workers sharing one client must collectively
        respect the bucket (the drain pool's eviction burst is the
        real-world shape)."""
        import threading as _threading

        store = InMemoryCluster()
        store.create(make_node("n1"))
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(
                KubeConfig(server=facade.url, qps=40.0, burst=4), timeout=10.0
            )
            errors = []

            def spin():
                try:
                    for _ in range(4):
                        client.get("Node", "n1")
                except Exception as err:  # noqa: BLE001
                    errors.append(err)

            threads = [_threading.Thread(target=spin) for _ in range(4)]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            _join_all(threads)
            elapsed = time.monotonic() - t0
        assert not errors
        # 16 requests, 4 burst, 40/s refill => >= 0.3 s
        assert elapsed >= 0.25, f"bucket not shared ({elapsed:.3f}s)"


class TestReconnectBackoff:
    """Held-watch retry pacing (client-go reflector parity): failures
    back off exponentially with full jitter; a healthy stream resets."""

    def test_grows_to_cap_with_jitter(self):
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import _ReconnectBackoff

        b = _ReconnectBackoff(base=0.2, factor=2.0, cap=30.0)
        delays = [b.next() for _ in range(12)]
        # each delay jitters in [0.5, 1.0] x the current interval
        expected = 0.2
        for d in delays:
            assert expected * 0.5 <= d <= expected
            expected = min(expected * 2.0, 30.0)
        # late retries sit at the cap's jitter window, not beyond
        assert delays[-1] <= 30.0

    def test_reset_restarts_from_base(self):
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import _ReconnectBackoff

        b = _ReconnectBackoff(base=0.2, factor=2.0, cap=30.0)
        for _ in range(6):
            b.next()
        b.reset()
        assert b.next() <= 0.2


class TestPriorityAndFairness:
    """APF max-in-flight load shedding (real-apiserver behavior the
    in-mem substrate must reproduce): overflow requests get 429 +
    Retry-After + the flow-schema header BEFORE processing, and the
    client transparently replays them — while PDB-driven eviction 429s
    (no APF header) still surface to the kubectl-style caller loop."""

    def test_overload_is_shed_and_transparently_retried(self):
        import threading as _threading

        store = InMemoryCluster()
        store.create(make_node("n1"))

        # hold the handler briefly so concurrency genuinely overlaps
        orig_get = InMemoryCluster.get

        def slow_get(self, kind, name, namespace=""):
            time.sleep(0.05)
            return orig_get(self, kind, name, namespace)

        facade = ApiServerFacade(store, max_inflight=2)
        facade.start()
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        errors = []
        try:
            InMemoryCluster.get = slow_get
            def spin():
                try:
                    for _ in range(3):
                        client.get("Node", "n1")
                except Exception as err:  # noqa: BLE001
                    errors.append(err)

            threads = [_threading.Thread(target=spin) for _ in range(8)]
            for t in threads:
                t.start()
            _join_all(threads)
        finally:
            InMemoryCluster.get = orig_get
            facade.stop()
        assert not errors, errors
        # with 8 workers racing a 2-seat server, shedding must have
        # actually happened — otherwise this test proves nothing
        assert facade.apf_state["rejected"] > 0
        assert client.overload_retries > 0

    def test_watch_requests_are_exempt(self):
        """A held watch occupies its seat for the whole hold; APF seats
        it once at admission.  The facade exempts watch=true entirely so
        a single held stream cannot starve the fleet's CRUD."""
        store = InMemoryCluster()
        store.create(make_node("n1"))
        facade = ApiServerFacade(store, max_inflight=1)
        facade.start()
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        try:
            client.start_held_watches(("Node",))
            # stream established and holding its seat
            _wait_until(lambda: _streams_open(client), what="the stream")
            for _ in range(5):
                client.get("Node", "n1")  # must not be starved
        finally:
            try:
                client.stop_held_watches()
            except Exception:  # noqa: BLE001
                pass
            facade.stop()
        assert facade.apf_state["rejected"] == 0

    def test_pdb_eviction_429_still_surfaces(self):
        """An Eviction rejected by a PodDisruptionBudget is a POLICY
        429 (no APF header): the client must NOT transparently retry it
        — the drain manager's kubectl-style loop owns that decision."""
        store = InMemoryCluster()
        store.create(make_node("n1"))
        store.create(
            {
                "apiVersion": "policy/v1",
                "kind": "PodDisruptionBudget",
                "metadata": {"name": "pdb", "namespace": "d"},
                "spec": {
                    "minAvailable": 1,
                    "selector": {"matchLabels": {"app": "x"}},
                },
            }
        )
        store.create(
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": "p1", "namespace": "d",
                             "labels": {"app": "x"}},
                "spec": {"nodeName": "n1"},
                "status": {"phase": "Running",
                           "conditions": [{"type": "Ready",
                                           "status": "True"}]},
            }
        )
        facade = ApiServerFacade(store, max_inflight=8)
        facade.start()
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        try:
            with pytest.raises(TooManyRequestsError):
                client.evict("p1", namespace="d")
        finally:
            facade.stop()
        assert client.overload_retries == 0


class TestFilteredWatch:
    """Server-side label-filtered watches (client-go's
    ListOptions.LabelSelector on watch): non-matching frames never
    cross the wire, and selector TRANSITIONS rewrite the frame type —
    an object that stops matching arrives as DELETED, one that starts
    matching as ADDED (the apiserver watch-cache contract)."""

    def _mk_pod(self, name, app):
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": name, "namespace": "d",
                         "labels": {"app": app}},
            "spec": {"nodeName": "n1"},
            "status": {"phase": "Running"},
        }

    def test_held_stream_delivers_matching_only_with_transitions(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client.create(self._mk_pod("driver-1", "driver"))
            client.create(self._mk_pod("noise-1", "other"))
            client.start_held_watches(
                ("Pod",), hold_seconds=3.0,
                label_selectors={"Pod": "app=driver"},
            )
            try:
                seq0 = client.journal_seq()
                # churn: matching create, noise create, a transition OUT
                # and a transition IN
                client.create(self._mk_pod("driver-2", "driver"))
                client.create(self._mk_pod("noise-2", "other"))
                client.patch(
                    "Pod", "driver-1",
                    {"metadata": {"labels": {"app": "other"}}},
                    namespace="d",
                )  # stops matching -> DELETED
                client.patch(
                    "Pod", "noise-1",
                    {"metadata": {"labels": {"app": "driver"}}},
                    namespace="d",
                )  # starts matching -> ADDED
                deadline = time.monotonic() + 5.0
                seen = []
                while time.monotonic() < deadline and len(seen) < 3:
                    for ev in client.events_since(seq0, kind="Pod"):
                        name = (
                            (ev.new or ev.old or {})
                            .get("metadata", {})
                            .get("name")
                        )
                        seen.append((ev.type, name))
                    time.sleep(0.05)
            finally:
                client.stop_held_watches()
        kinds_seen = {n for _t, n in seen}
        assert "noise-2" not in kinds_seen, seen
        assert ("Added", "driver-2") in seen, seen
        assert ("Deleted", "driver-1") in seen, seen
        assert ("Added", "noise-1") in seen, seen

    def test_seed_list_is_selector_scoped(self):
        """The informer's initial list rides the same selector, so the
        old-object synthesis view only tracks matching objects."""
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client.create(self._mk_pod("driver-1", "driver"))
            client.create(self._mk_pod("noise-1", "other"))
            client.start_held_watches(
                ("Pod",), hold_seconds=3.0,
                label_selectors={"Pod": "app=driver"},
            )
            try:
                with client._last_seen_lock:
                    names = {
                        k[2] for k in client._last_seen if k[0] == "Pod"
                    }
            finally:
                client.stop_held_watches()
        assert "driver-1" in names and "noise-1" not in names

    def test_bounded_poll_honors_selector(self):
        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client._watch_selectors = {"Pod": "app=driver"}
            seq0 = client.journal_seq()
            client.create(self._mk_pod("driver-1", "driver"))
            client.create(self._mk_pod("noise-1", "other"))
            events = client.events_since(seq0, kind="Pod")
            names = [
                (e.new or {}).get("metadata", {}).get("name") for e in events
            ]
        assert names == ["driver-1"], names


class TestEarlyRejectionBodyDrain:
    """Regression (found by the overload soak): an early rejection —
    401 auth, APF 429, bad route — must still consume the request BODY,
    else the unread bytes desynchronize the keep-alive connection and
    the server parses them as the next request line ('Bad request
    syntax')."""

    def test_rejected_patch_does_not_desync_the_connection(self):
        import json
        from http.client import HTTPConnection

        store = InMemoryCluster()
        store.create(make_node("n1"))
        facade = ApiServerFacade(store, accepted_tokens={"good"})
        facade.start()
        try:
            from urllib.parse import urlparse

            parsed = urlparse(facade.url)
            conn = HTTPConnection(parsed.hostname, parsed.port, timeout=5)
            body = json.dumps(
                {"metadata": {"labels": {"x": "1"}}}
            ).encode()
            # 1: unauthorized PATCH WITH a body -> 401 before any
            # handler ran
            conn.request(
                "PATCH",
                "/api/v1/nodes/n1",
                body=body,
                headers={"Content-Type": "application/merge-patch+json"},
            )
            resp = conn.getresponse()
            assert resp.status == 401
            resp.read()
            # 2: next request on the SAME connection must parse cleanly
            conn.request(
                "GET",
                "/api/v1/nodes/n1",
                headers={"Authorization": "Bearer good"},
            )
            resp2 = conn.getresponse()
            body2 = resp2.read()
            assert resp2.status == 200, (resp2.status, body2[:200])
            conn.close()
        finally:
            facade.stop()


class TestInClusterConfig:
    """KubeConfig.in_cluster() — the rest.InClusterConfig analog
    (reference loads config the same way via crdutil.go:56-67)."""

    def test_reads_sa_mount(self, tmp_path, monkeypatch):
        from k8s_operator_libs_tpu_torch.cluster import kubeclient as kc

        (tmp_path / "token").write_text("sa-token-xyz\n")
        (tmp_path / "ca.crt").write_text("CERT")
        monkeypatch.setattr(kc, "_SA_DIR", str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        cfg = kc.KubeConfig.in_cluster()
        assert cfg.server == "https://10.0.0.1:6443"
        assert cfg.token == "sa-token-xyz"
        assert cfg.ca_file == str(tmp_path / "ca.crt")

    def test_missing_ca_is_none(self, tmp_path, monkeypatch):
        from k8s_operator_libs_tpu_torch.cluster import kubeclient as kc

        (tmp_path / "token").write_text("t")
        monkeypatch.setattr(kc, "_SA_DIR", str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "h")
        monkeypatch.delenv("KUBERNETES_SERVICE_PORT", raising=False)
        cfg = kc.KubeConfig.in_cluster()
        assert cfg.server == "https://h:443"
        assert cfg.ca_file is None

    def test_not_in_cluster_raises(self, monkeypatch):
        from k8s_operator_libs_tpu_torch.cluster import kubeclient as kc

        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        with pytest.raises(kc.KubeConfigError, match="not running"):
            kc.KubeConfig.in_cluster()

    def test_unreadable_token_raises(self, tmp_path, monkeypatch):
        from k8s_operator_libs_tpu_torch.cluster import kubeclient as kc

        monkeypatch.setattr(kc, "_SA_DIR", str(tmp_path / "absent"))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "h")
        with pytest.raises(kc.KubeConfigError, match="SA token"):
            kc.KubeConfig.in_cluster()


class TestClientErrorBranches:
    """Small error paths of KubeApiClient the rollout suites skip.
    All are client-side / pure — no server needed (the unsupported
    patch type is rejected before any request leaves the process)."""

    @staticmethod
    def _offline_client():
        # nothing listens on port 1; these paths never hit the network
        return KubeApiClient(KubeConfig(server="http://127.0.0.1:1"),
                             timeout=1.0)

    def test_unsupported_patch_type_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster import BadRequestError

        client = self._offline_client()
        with pytest.raises(BadRequestError, match="unsupported patch"):
            client.patch("Node", "n1", {"metadata": {}}, patch_type="json")

    def test_seed_bookmark_tolerates_malformed_rv(self):
        client = self._offline_client()
        # a body whose resourceVersion is not an int must not raise
        assert client._seed_bookmark(
            "Node", {"metadata": {"resourceVersion": "not-an-int"}}
        ) in (None, 0)
        assert client._seed_bookmark("Node", {}) in (None, 0)

    def test_status_reason_maps_to_error_classes(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import (
            ApiError,
            BadRequestError,
            InvalidError,
        )

        client = self._offline_client()
        assert isinstance(
            client._to_api_error(400, {"message": "m"}), BadRequestError
        )
        assert isinstance(
            client._to_api_error(422, {"message": "m", "reason": "Invalid"}),
            InvalidError,
        )
        # unknown status falls back to the base class
        err = client._to_api_error(508, {"message": "m"})
        assert type(err) is ApiError


class TestKubeconfigLoadErrors:
    """KubeConfig.load error/lookup branches (rest-config loading parity
    with the reference's ctrl.GetConfig, crdutil.go:56-67): KUBECONFIG
    env fallback, unreadable file, missing context/cluster entries,
    explicit context selection."""

    @staticmethod
    def _write(tmp_path, doc):
        import yaml as _yaml

        path = tmp_path / "kubeconfig"
        path.write_text(_yaml.safe_dump(doc))
        return str(path)

    def _doc(self, **over):
        doc = {
            "apiVersion": "v1",
            "kind": "Config",
            "current-context": "a",
            "contexts": [
                {"name": "a", "context": {"cluster": "c1", "user": "u"}},
                {"name": "b", "context": {"cluster": "c2", "user": "u"}},
            ],
            "clusters": [
                {"name": "c1", "cluster": {"server": "http://one:1"}},
                {"name": "c2", "cluster": {"server": "http://two:2"}},
            ],
            "users": [{"name": "u", "user": {"token": "t"}}],
        }
        doc.update(over)
        return doc

    def test_kubeconfig_env_fallback(self, tmp_path, monkeypatch):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig

        path = self._write(tmp_path, self._doc())
        monkeypatch.setenv("KUBECONFIG", path)
        cfg = KubeConfig.load()
        assert cfg.server == "http://one:1"
        assert cfg.token == "t"

    def test_explicit_context_selects_cluster(self, tmp_path):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig

        path = self._write(tmp_path, self._doc())
        assert KubeConfig.load(path, context="b").server == "http://two:2"

    def test_unreadable_file_raises(self, tmp_path):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeConfigError

        with pytest.raises(KubeConfigError, match="cannot read"):
            KubeConfig.load(str(tmp_path / "absent"))

    def test_missing_current_context_raises(self, tmp_path):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeConfigError

        path = self._write(tmp_path, self._doc(**{"current-context": ""}))
        with pytest.raises(KubeConfigError, match="no current-context"):
            KubeConfig.load(path)

    def test_unknown_context_raises(self, tmp_path):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeConfigError

        path = self._write(tmp_path, self._doc())
        with pytest.raises(KubeConfigError, match="not found"):
            KubeConfig.load(path, context="nope")

    def test_context_pointing_at_missing_cluster_raises(self, tmp_path):
        from k8s_operator_libs_tpu_torch.cluster import KubeConfig
        from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeConfigError

        doc = self._doc()
        doc["clusters"] = [doc["clusters"][1]]  # drop c1
        path = self._write(tmp_path, doc)
        with pytest.raises(KubeConfigError, match="cluster 'c1'"):
            KubeConfig.load(path)


class TestOverloadReplayHeaderParsing:
    """The APF 429 replay's Retry-After parsing: a malformed header
    must fall back to 1s (clamped), not crash the replay loop."""

    def test_malformed_retry_after_falls_back(self, monkeypatch):
        import json as _json

        from k8s_operator_libs_tpu_torch.cluster import KubeApiClient, KubeConfig

        client = KubeApiClient(
            KubeConfig(server="http://127.0.0.1:1"), timeout=1.0
        )

        class FakeResp:
            def __init__(self, status, headers=None):
                self.status = status
                self._headers = headers or {}

            def getheader(self, name):
                return self._headers.get(name)

        calls = {"n": 0}
        ok_body = _json.dumps(
            {"kind": "Node", "metadata": {"name": "n1",
                                          "resourceVersion": "5"}}
        ).encode()

        def fake_transport(method, path, payload, content_type,
                           refresh_if_generation=None):
            calls["n"] += 1
            if calls["n"] == 1:
                return (
                    FakeResp(429, {
                        "X-Kubernetes-PF-FlowSchema-UID": "apf",
                        "Retry-After": "soon",  # unparseable
                    }),
                    b"{}",
                )
            return FakeResp(200), ok_body

        monkeypatch.setattr(client, "_transport", fake_transport)
        monkeypatch.setattr("time.sleep", lambda s: None)
        _, body = client._request("GET", "/api/v1/nodes/n1")
        assert body["metadata"]["name"] == "n1"
        assert client.overload_retries == 1
        assert calls["n"] == 2

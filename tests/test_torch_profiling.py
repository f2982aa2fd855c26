"""The port's continuous profiling plane (obs/profiling.py): sampler windows,
span self/child attribution through the tracing observer hook, the
collapsed/speedscope exporters and their round trips, the differential
diff, the /debug/profile surface, the profile CLI, and the shared
interleaved-overhead methodology (obs/overhead.py) the bench gates
ride on.

Every class of ``tests/test_profiling.py``, as cases of the same names,
on the port, but ``TestProfileCli``: it calls the package's
``__main__``, which is not ported yet."""

import json
import threading
import time
import urllib.request

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.controller.ops_server import OpsServer
from k8s_operator_libs_tpu_torch.obs import overhead, profiling, tracing

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def registry():
    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    yield reg
    metrics.set_default_registry(prev)


@pytest.fixture()
def profiler(registry):
    prof = profiling.SamplingProfiler(
        hz=250.0, window_seconds=30.0, registry=registry
    )
    prev = tracing.span_observer()
    yield prof
    prof.stop()
    tracing.set_span_observer(prev)


def _spin(seconds: float) -> int:
    deadline = time.monotonic() + seconds
    acc = 0
    while time.monotonic() < deadline:
        for i in range(500):
            acc += i * i
    return acc


# ---------------------------------------------------------------- sampler
class TestSampler:
    def test_samples_accumulate_and_stop_rotates(self, profiler):
        profiler.start()
        _spin(0.1)
        profiler.stop()
        snap = profiler.snapshot()
        assert not snap["running"]
        assert snap["samples_total"] > 0
        assert snap["windows"], "stop must rotate the open window out"
        assert sum(w["samples"] for w in snap["windows"]) > 0

    def test_enabled_false_pauses_sampling(self, profiler):
        profiler.enabled = False
        profiler.start()
        _spin(0.05)
        assert profiler.samples_total == 0
        profiler.enabled = True
        _spin(0.05)
        profiler.stop()
        assert profiler.samples_total > 0

    def test_ring_is_bounded(self, registry):
        prof = profiling.SamplingProfiler(
            hz=500.0, window_seconds=0.01, capacity=3, registry=registry
        )
        prof.start()
        _spin(0.25)
        prof.stop()
        assert len(prof.snapshot()["windows"]) <= 3

    def test_capture_serves_an_on_demand_window(self, profiler):
        # not running: capture must start/stop the sampler itself
        out = profiler.capture(0.1)
        assert len(out["windows"]) == 1
        assert out["windows"][0]["samples"] > 0
        assert not profiler.running

    def test_overhead_self_measure_and_metrics(self, profiler, registry):
        profiler.start()
        _spin(0.15)
        profiler.stop()
        assert 0 < profiler.overhead < 0.5
        out = registry.render()
        assert "profiler_samples_total" in out
        assert "profile_overhead" in out

    def test_overhead_is_lifetime_not_per_run(self, registry):
        """Regression: overhead must divide the CUMULATIVE
        sampler cost by the cumulative wall clock — a per-run
        denominator inflated the gauge N-fold over N stop/start cycles
        (every ?seconds= capture on a stopped profiler is one)."""
        prof = profiling.SamplingProfiler(hz=250.0, registry=registry)
        for _ in range(4):
            prof.start()
            _spin(0.05)
            prof.stop()
        assert prof.overhead < 0.5, (
            f"overhead {prof.overhead} — per-run denominator regression"
        )

    def test_concurrent_captures_share_one_temp_sampler(self, profiler):
        """Regression: two overlapping captures on a STOPPED
        profiler must not double-start the sampler (an orphaned thread
        double-counts every window forever), and the shorter capture's
        cleanup must not cut the longer one's window short."""
        results = {}

        def cap(name, seconds):
            results[name] = profiler.capture(seconds)

        t1 = threading.Thread(target=cap, args=("short", 0.1))
        t2 = threading.Thread(target=cap, args=("long", 0.3))
        t1.start()
        t2.start()
        t1.join()
        # the short capture finished; the long one still holds the
        # temp-started sampler
        assert profiler.running, "short capture stopped a shared sampler"
        t2.join()
        assert not profiler.running, "last capture out must stop it"
        assert results["long"]["windows"][0]["samples"] > results["short"][
            "windows"
        ][0]["samples"], "long capture lost its tail"
        # exactly one sampler thread existed: a double-start would keep
        # sampling after stop
        before = profiler.samples_total
        time.sleep(0.1)
        assert profiler.samples_total == before, "orphaned sampler thread"

    def test_reinstall_clears_stale_span_stacks(self, profiler):
        """Regression: a span ending while the observer is
        uninstalled is never popped; reinstalling must not resurrect
        its stale stack entry and attribute every later sample to it."""
        tracer = tracing.Tracer()
        profiler.install()
        span = tracer.start_span("stale")
        profiler.uninstall()
        span.end()  # unobserved pop
        profiler.install()
        assert profiler._span_stacks == {}, "stale span stack survived"
        profiler.start()
        _spin(0.05)
        profiler.stop()
        profiler.uninstall()
        spans = profiling.merged_span_times(profiler.snapshot())
        assert "stale" not in spans, spans

    def test_constructor_validation(self):
        with pytest.raises(ValueError):
            profiling.SamplingProfiler(hz=0)
        with pytest.raises(ValueError):
            profiling.SamplingProfiler(window_seconds=0)
        with pytest.raises(ValueError):
            profiling.SamplingProfiler(capacity=0)


# ------------------------------------------------------- span attribution
class TestSpanAttribution:
    def test_self_and_child_time_split(self, profiler):
        tracer = tracing.Tracer()
        profiler.install()
        profiler.start()
        with tracer.start_span("Outer"):
            with tracer.start_span("Inner"):
                _spin(0.15)
        profiler.stop()
        profiler.uninstall()
        spans = profiling.merged_span_times(profiler.snapshot())
        assert spans["Inner"]["self"] > 0
        outer = spans["Outer"]
        assert outer["total"] >= spans["Inner"]["self"]
        assert outer["total"] - outer["self"] > 0, "Outer's time is child time"

    def test_span_frames_decompose_self_time(self, profiler):
        tracer = tracing.Tracer()
        profiler.install()
        profiler.start()
        with tracer.start_span("Hot"):
            _spin(0.15)
        profiler.stop()
        profiler.uninstall()
        frames = profiling.merged_span_frames(profiler.snapshot())["Hot"]
        top = max(frames.items(), key=lambda kv: kv[1])[0]
        assert top == "test_torch_profiling._spin", frames

    def test_cross_thread_span_attributes_to_running_thread(self, profiler):
        tracer = tracing.Tracer()
        profiler.install()
        profiler.start()
        with tracer.start_span("Root") as root:
            carrier = root.traceparent

            def work():
                with tracer.start_span("Worker", traceparent=carrier):
                    _spin(0.15)

            t = threading.Thread(target=work)
            t.start()
            t.join()
        profiler.stop()
        profiler.uninstall()
        snap = profiler.snapshot()
        spans = profiling.merged_span_times(snap)
        assert spans["Worker"]["self"] > 0
        # the spin's samples land on the WORKER span (the thread that
        # ran them), not on Root — whose own self-time is the t.join()
        # wait on the main thread (an honest attribution of both)
        frames = profiling.merged_span_frames(snap)
        worker_top = max(
            frames["Worker"].items(), key=lambda kv: kv[1]
        )[0]
        assert worker_top == "test_torch_profiling._spin", frames["Worker"]
        assert not any(
            leaf == "test_torch_profiling._spin" for leaf in frames.get("Root", {})
        ), frames.get("Root")

    def test_observer_uninstall_restores_previous(self):
        prev = tracing.span_observer()
        prof = profiling.SamplingProfiler()
        prof.install()
        assert tracing.span_observer() is prof
        prof.uninstall()
        assert tracing.span_observer() is None
        tracing.set_span_observer(prev)

    def test_span_started_before_install_pops_cleanly(self, profiler):
        tracer = tracing.Tracer()
        span = tracer.start_span("pre-install")
        profiler.install()
        # ending a span the observer never saw must not raise or corrupt
        span.end()
        profiler.uninstall()
        assert profiler._span_stacks == {}


# ------------------------------------------------------------- exporters
def _window(stacks, span_self=None, span_total=None, span_frames=None):
    return {
        "started_unix": 0.0,
        "samples": sum(stacks.values()),
        "stacks": stacks,
        "span_self": span_self or {},
        "span_total": span_total or {},
        "span_frames": span_frames or {},
    }


class TestExporters:
    payload = {
        "running": False,
        "hz": 67.0,
        "overhead": 0.01,
        "windows": [
            _window({"a.main;b.build": 3, "a.main;c.apply;d.copy": 7}),
            _window({"a.main;b.build": 2}),
        ],
    }

    def test_collapsed_round_trip(self):
        text = profiling.to_collapsed(self.payload)
        counts = profiling.parse_collapsed(text)
        assert counts == {"a.main;b.build": 5, "a.main;c.apply;d.copy": 7}

    def test_parse_collapsed_rejects_garbage(self):
        with pytest.raises(ValueError):
            profiling.parse_collapsed("this is not a dump")

    def test_speedscope_round_trip(self):
        scope = json.loads(json.dumps(profiling.to_speedscope(self.payload)))
        assert scope["$schema"].startswith("https://www.speedscope.app")
        back = profiling.snapshot_from_payload(scope)
        assert profiling.merged_stacks(back) == profiling.merged_stacks(
            self.payload
        )

    def test_snapshot_from_payload_rejects_unknown(self):
        with pytest.raises(ValueError):
            profiling.snapshot_from_payload({"nope": 1})
        with pytest.raises(ValueError):
            profiling.snapshot_from_payload({"windows": [{"stacks": 3}]})

    def test_self_frame_counts_qualify_generic_waits(self):
        counts = profiling.self_frame_counts(
            {
                "a.main;cache.wait_for_update;threading.wait": 5,
                "a.main;b.join;threading.wait": 2,
                "a.main;d.copy": 1,
            }
        )
        assert counts == {
            "cache.wait_for_update>wait": 5,
            "b.join>wait": 2,
            "d.copy": 1,
        }

    def test_top_span_frames_prefers_attribution_with_fallback(self):
        attributed = {
            "running": False,
            "windows": [
                _window(
                    {"idle.pool;threading.wait": 90, "w.work;x.hot": 10},
                    span_frames={"Apply": {"x.hot": 10}},
                )
            ],
        }
        top = profiling.top_span_frames(attributed, n=1)
        assert top[0][0] == "x.hot" and top[0][1] == 1.0
        bare = {
            "running": False,
            "windows": [_window({"w.work;x.hot": 10})],
        }
        assert profiling.top_span_frames(bare, n=1)[0][0] == "x.hot"

    def test_render_report_names_spans_and_frames(self):
        payload = {
            "running": True,
            "hz": 67.0,
            "overhead": 0.012,
            "windows": [
                _window(
                    {"a.main;x.hot": 9, "a.main;y.cold": 1},
                    span_self={"Apply": 9},
                    span_total={"Apply": 9, "Reconcile": 10},
                    span_frames={"Apply": {"x.hot": 9}},
                )
            ],
        }
        out = profiling.render_report(payload)
        assert "Apply" in out and "x.hot" in out and "Reconcile" in out


class TestDiff:
    def test_diff_ranks_by_self_share_regression(self):
        old = {"m.a;f.one": 50, "m.a;f.two": 50}
        new = {"m.a;f.one": 20, "m.a;f.two": 50, "m.a;f.three": 30}
        top = profiling.diff_collapsed(old, new)
        assert top[0]["frame"] == "f.three"
        assert top[0]["old_pct"] == 0.0 and top[0]["new_pct"] == 30.0
        assert top[-1]["frame"] == "f.one"  # the improvement ranks last
        assert top[-1]["delta_pct"] == pytest.approx(-30.0)

    def test_diff_handles_empty_sides(self):
        assert profiling.diff_collapsed({}, {}) == []
        top = profiling.diff_collapsed({}, {"a.b;c.d": 5})
        assert top[0]["frame"] == "c.d" and top[0]["new_pct"] == 100.0


class TestHeapSnapshot:
    def test_reports_not_tracing_without_tracemalloc(self):
        import tracemalloc

        if tracemalloc.is_tracing():
            pytest.skip("tracemalloc already on in this process")
        out = profiling.heap_snapshot()
        assert out == {"tracing": False, "top": []}

    def test_reports_top_sites_when_tracing(self):
        import tracemalloc

        was_tracing = tracemalloc.is_tracing()
        if not was_tracing:
            tracemalloc.start()
        try:
            blob = [list(range(100)) for _ in range(100)]
            out = profiling.heap_snapshot(top=5)
            assert out["tracing"] is True
            assert out["top"] and out["traced_current_bytes"] > 0
            del blob
        finally:
            if not was_tracing:
                tracemalloc.stop()


# --------------------------------------------------------- /debug/profile
class TestDebugProfileEndpoint:
    def _get(self, url):
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    @pytest.fixture()
    def served(self, profiler):
        profiler.install()
        profiler.start()
        tracer = tracing.Tracer()
        with tracer.start_span("ServeSpan"):
            _spin(0.12)
        profiler.stop()
        profiler.uninstall()
        srv = OpsServer(port=0, host="127.0.0.1", profiler=profiler).start()
        yield srv
        srv.stop()

    def test_native_payload_and_windows_param(self, served):
        status, body = self._get(served.url + "/debug/profile")
        assert status == 200
        payload = json.loads(body)
        assert payload["windows"]
        assert profiling.merged_span_times(payload)["ServeSpan"]["self"] > 0
        status, body = self._get(served.url + "/debug/profile?windows=1")
        assert status == 200 and len(json.loads(body)["windows"]) <= 1

    def test_collapsed_and_speedscope_formats(self, served):
        status, body = self._get(served.url + "/debug/profile?fmt=collapsed")
        assert status == 200
        assert profiling.parse_collapsed(body)
        status, body = self._get(served.url + "/debug/profile?fmt=speedscope")
        assert status == 200
        assert json.loads(body)["$schema"].startswith(
            "https://www.speedscope.app"
        )

    def test_bad_fmt_and_bad_seconds_are_400(self, served):
        assert self._get(served.url + "/debug/profile?fmt=pprof")[0] == 400
        assert self._get(served.url + "/debug/profile?seconds=0")[0] == 400
        assert self._get(served.url + "/debug/profile?seconds=90")[0] == 400
        assert self._get(served.url + "/debug/profile?seconds=wat")[0] == 400

    def test_on_demand_capture_window(self, served):
        status, body = self._get(served.url + "/debug/profile?seconds=0.2")
        assert status == 200
        payload = json.loads(body)
        assert len(payload["windows"]) == 1

    def test_heap_param_attaches_tracemalloc_state(self, served):
        status, body = self._get(served.url + "/debug/profile?heap=1")
        assert status == 200
        assert "tracing" in json.loads(body)["heap"]


# ------------------------------------------------- overhead methodology
class TestInterleavedOverhead:
    def test_measures_a_real_overhead(self):
        def run_cycle():
            _spin(0.004 if state["on"] else 0.002)

        state = {"on": False}

        def set_side(enabled):
            state["on"] = enabled

        pct = overhead.interleaved_overhead_pct(run_cycle, set_side, pairs=12)
        assert 60 < pct < 140  # a 2x slowdown measured as ~100%

    def test_near_zero_when_sides_identical(self):
        def run_cycle():
            _spin(0.002)

        pct = overhead.interleaved_overhead_pct(
            run_cycle, lambda enabled: None, pairs=12
        )
        assert abs(pct) < 25  # noise floor, not a phantom 2x

    def test_leaves_feature_enabled_and_validates(self):
        state = {"on": False}
        overhead.interleaved_overhead_pct(
            lambda: None, lambda e: state.__setitem__("on", e), pairs=1
        )
        assert state["on"] is True
        with pytest.raises(ValueError):
            overhead.interleaved_overhead_pct(
                lambda: None, lambda e: None, pairs=0
            )

    def test_iq_mean(self):
        assert overhead.iq_mean([1.0]) == 1.0
        # outer quartiles shed: the outliers do not move the estimate
        values = [1.0] * 8 + [100.0, -100.0]
        assert overhead.iq_mean(values) == 1.0
        with pytest.raises(ValueError):
            overhead.iq_mean([])

    def test_deterministic_side_order(self):
        orders = []
        overhead.interleaved_overhead_pct(
            lambda: None, lambda e: orders.append(e), pairs=4
        )
        again = []
        overhead.interleaved_overhead_pct(
            lambda: None, lambda e: again.append(e), pairs=4
        )
        assert orders == again  # seeded: reproducible run-to-run


class TestSelftest:
    def test_selftest_passes(self):
        out = profiling.selftest()
        assert "profile selftest ok" in out

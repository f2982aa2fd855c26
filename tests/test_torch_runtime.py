"""The port's control-plane GC and scheduler profiles
(k8s_operator_libs_tpu_torch/runtime.py).

Every class of ``tests/test_runtime.py``, as cases of the same names,
runs on the port: thresholds applied and restored exactly,
freeze/unfreeze paired, and the restore round-tripping under nesting and
exception paths for both ``tune_gc`` and ``tune_scheduler``.
"""

import gc
import sys

from k8s_operator_libs_tpu_torch import runtime


class TestTuneGc:
    def test_applies_and_returns_previous_thresholds(self):
        before = gc.get_threshold()
        try:
            prev = runtime.tune_gc(gen0=12345, gen1=7, gen2=9)
            assert prev == before
            assert gc.get_threshold() == (12345, 7, 9)
        finally:
            runtime.restore_gc(before)
        assert gc.get_threshold() == before

    def test_defaults_raise_gen0_substantially(self):
        before = gc.get_threshold()
        try:
            runtime.tune_gc()
            gen0, _, _ = gc.get_threshold()
            # the whole point: amortize young-gen scans ~two orders of
            # magnitude over CPython's default 700
            assert gen0 >= 100 * 700
        finally:
            runtime.restore_gc(before)

    def test_context_manager_restores_on_exit_and_on_error(self):
        before = gc.get_threshold()
        with runtime.tuned_gc(gen0=22222):
            assert gc.get_threshold()[0] == 22222
        assert gc.get_threshold() == before
        try:
            with runtime.tuned_gc(gen0=33333):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert gc.get_threshold() == before

    def test_freeze_baseline_moves_objects_to_permanent_generation(self):
        before = gc.get_threshold()
        baseline = gc.get_freeze_count()
        with runtime.tuned_gc(freeze_baseline=True):
            # everything live at entry (≥ the prior permanent set) is
            # now exempt from cyclic scanning
            assert gc.get_freeze_count() > baseline
        # unfreeze on exit drains the WHOLE permanent generation —
        # including objects other components had frozen (documented
        # restore_gc caveat; CPython keeps no per-freezer record)
        assert gc.get_freeze_count() == 0
        assert gc.get_threshold() == before

    def test_nested_contexts_restore_outer_then_original(self):
        """A/B harnesses nest tuned_gc inside tuned_gc (bench sections
        under an outer profile): each exit must restore the PROFILE IN
        FORCE AT ITS ENTRY, not the process default."""
        before = gc.get_threshold()
        with runtime.tuned_gc(gen0=11111):
            with runtime.tuned_gc(gen0=22222, gen1=3, gen2=4):
                assert gc.get_threshold() == (22222, 3, 4)
            assert gc.get_threshold()[0] == 11111
        assert gc.get_threshold() == before

    def test_nested_restore_under_exception(self):
        before = gc.get_threshold()
        try:
            with runtime.tuned_gc(gen0=11111):
                with runtime.tuned_gc(gen0=22222):
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert gc.get_threshold() == before


class TestTuneScheduler:
    def test_applies_and_returns_previous_interval(self):
        before = sys.getswitchinterval()
        prev = runtime.tune_scheduler(0.002)
        try:
            assert prev == before
            assert sys.getswitchinterval() == 0.002
        finally:
            sys.setswitchinterval(prev)
        assert sys.getswitchinterval() == before

    def test_default_lowers_the_interval(self):
        before = sys.getswitchinterval()
        prev = runtime.tune_scheduler()
        try:
            # the point: a thread-heavy control plane needs a finer
            # quantum than CPython's 5 ms default
            assert sys.getswitchinterval() < before
        finally:
            sys.setswitchinterval(prev)

    def test_context_manager_restores_on_exit_and_on_error(self):
        before = sys.getswitchinterval()
        with runtime.tuned_scheduler(0.002):
            assert sys.getswitchinterval() == 0.002
        assert sys.getswitchinterval() == before
        try:
            with runtime.tuned_scheduler(0.003):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert sys.getswitchinterval() == before

    def test_nested_contexts_round_trip(self):
        """bench --http-only wraps tuned_gc() AND tuned_scheduler()
        around nested best-of loops; both profiles must unwind through
        every level back to the originals."""
        gc_before = gc.get_threshold()
        sched_before = sys.getswitchinterval()
        try:
            with runtime.tuned_gc(gen0=44444), runtime.tuned_scheduler(0.002):
                with runtime.tuned_scheduler(0.004):
                    assert sys.getswitchinterval() == 0.004
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert gc.get_threshold() == gc_before
        assert sys.getswitchinterval() == sched_before


class TestGcStillCollects:
    def test_collection_still_enabled_after_tuning(self):
        """The profile must amortize, never disable: real cycles (http
        machinery, tracebacks) still need collecting in a long-running
        operator."""
        before = gc.get_threshold()
        try:
            runtime.tune_gc()
            assert gc.isenabled()

            class Node:
                pass

            a, b = Node(), Node()
            a.peer, b.peer = b, a
            del a, b
            assert gc.collect() >= 2  # the cycle is collectable
        finally:
            runtime.restore_gc(before)

"""The classes of ``tests/test_profiling.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestProfileCli``.  Its profile dump is
taken in a fresh interpreter (``_write_dump``): the sampler samples
every thread, and a test worker's threads left by earlier files can
outweigh the spin the diff test looks for."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.controller.ops_server import OpsServer
from k8s_operator_libs_tpu_torch.obs import profiling, tracing
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


def _write_dump(path: str) -> None:
    """Profile a traced 0.12 s spin at 250 Hz; write the snapshot to *path*."""
    profiler = profiling.SamplingProfiler(
        hz=250.0, window_seconds=30.0, registry=metrics.MetricsRegistry()
    )
    tracer = tracing.Tracer()
    profiler.install()
    profiler.start()
    with tracer.start_span("CliSpan"):
        _spin(0.12)
    profiler.stop()
    profiler.uninstall()
    Path(path).write_text(json.dumps(profiler.snapshot()))


# ------------------------------------------------------------------- CLI
class TestProfileCli:
    def _main(self, *argv):
        from k8s_operator_libs_tpu_torch.__main__ import main

        return main(list(argv))

    @pytest.fixture()
    def dump(self, tmp_path):
        path = tmp_path / "profile.json"
        tests = Path(__file__).resolve().parent
        code = (f"import sys; sys.path[:0] = [{str(tests)!r}, {str(tests.parent)!r}]; "
                f"import test_torch_profiling_cli as t; t._write_dump({str(path)!r})")
        subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
        return path

    def test_report_render_from_native_dump(self, dump, capsys):
        assert self._main("profile", "--file", str(dump)) == 0
        out = capsys.readouterr().out
        assert "CliSpan" in out and "top self-time frames" in out

    def test_collapsed_and_speedscope_render(self, dump, capsys, tmp_path):
        assert (
            self._main("profile", "--file", str(dump), "--fmt", "collapsed")
            == 0
        )
        collapsed = capsys.readouterr().out
        assert profiling.parse_collapsed(collapsed)
        # collapsed text itself is a loadable dump
        text = tmp_path / "dump.txt"
        text.write_text(collapsed)
        assert self._main("profile", "--file", str(text)) == 0
        assert (
            self._main("profile", "--file", str(dump), "--fmt", "speedscope")
            == 0
        )
        assert "$schema" in capsys.readouterr().out

    def test_diff_subcommand(self, dump, capsys, tmp_path):
        assert (
            self._main("profile", "--file", str(dump), "--fmt", "collapsed")
            == 0
        )
        collapsed = capsys.readouterr().out
        counts = profiling.parse_collapsed(collapsed)
        spin_stacks = {
            s for s in counts if s.endswith("test_torch_profiling_cli._spin")
        }
        assert spin_stacks
        old = tmp_path / "old.txt"
        old.write_text(
            "\n".join(
                f"{s} {c}"
                for s, c in counts.items()
                if s not in spin_stacks
            )
            + "\nm.base;m.other 50\n"
        )
        new = tmp_path / "new.txt"
        new.write_text(collapsed)
        assert self._main("profile", "diff", str(old), str(new)) == 0
        out = capsys.readouterr().out
        assert "test_torch_profiling_cli._spin" in out.splitlines()[1]
        # machine output
        assert (
            self._main(
                "profile", "diff", str(old), str(new), "--json"
            )
            == 0
        )
        parsed = json.loads(capsys.readouterr().out)
        assert parsed[0]["frame"] == "test_torch_profiling_cli._spin"

    def test_error_exits(self, capsys, tmp_path):
        assert self._main("profile") == 2
        assert self._main("profile", "--file", "/does/not/exist") == 2
        assert self._main("profile", "diff", "only-one") == 2
        bad = tmp_path / "bad.json"
        bad.write_text("{\"nope\": 1}")
        assert self._main("profile", "--file", str(bad)) == 2
        assert (
            self._main("profile", "--file", str(bad), "--url", "http://x")
            == 2
        )
        capsys.readouterr()

    def test_live_capture_from_ops_server(self, profiler, capsys):
        profiler.start()
        _spin(0.1)
        profiler.stop()
        srv = OpsServer(port=0, host="127.0.0.1", profiler=profiler).start()
        try:
            assert self._main("profile", "--url", srv.url) == 0
            assert "window" in capsys.readouterr().out
        finally:
            srv.stop()

    def test_selftest_through_the_cli(self, capsys):
        assert self._main("profile", "--selftest") == 0
        assert "profile selftest ok" in capsys.readouterr().out

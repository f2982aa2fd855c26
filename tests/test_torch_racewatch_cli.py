"""The classes of ``tests/test_racewatch.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestProfilePlaneExport`` (``test_profile_cli_locks_flag``)."""

import threading

import pytest

from k8s_operator_libs_tpu_torch.obs import racewatch
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def watch():
    """A clean, installed watch per test — WITHOUT disturbing a
    session-wide RACEWATCH=1 run: the state swap isolates this test's
    stats/edges, and the teardown only unpatches the constructors when
    the session had not installed them (wiping the suite-wide graph or
    disarming conftest's sessionfinish gate would make `make
    verify-race`'s zero-cycles check vacuous for every test collected
    after this file)."""
    prev_state = racewatch.swap_state()
    session_installed = prev_state.installed
    racewatch.install()
    yield racewatch
    if not session_installed:
        racewatch.uninstall()  # session had no watch: restore real ctors
    racewatch.swap_state(prev_state)


class TestProfilePlaneExport:
    def test_profile_cli_locks_flag(self, watch, tmp_path, capsys):
        """`profile --file dump.json --locks` renders the lock section
        from a dump that carries one."""
        import json

        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
        from k8s_operator_libs_tpu_torch.obs import profiling

        lock = threading.Lock()
        with lock:
            pass
        snap = profiling.default_profiler().snapshot()
        dump = dict(snap, locks=racewatch.report())
        path = tmp_path / "dump.json"
        path.write_text(json.dumps(dump))
        rc = cli_main(["profile", "--file", str(path), "--locks"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "racewatch:" in out
        assert "lock sites" in out

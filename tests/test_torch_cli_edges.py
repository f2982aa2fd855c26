"""CLI edge paths in ``__main__.py`` the happy-path suites never hit:
argument validators, selector parsing, and the exit-code conventions
(141 on a closed pipe, 130 on Ctrl-C) that ``--wait-exit-code``
consumers and shell scripts depend on.

Every class of ``tests/test_cli_edges.py``, as cases of the same names, on the
port (``k8s_operator_libs_tpu_torch``) in its GPU-fleet vocabulary."""

from __future__ import annotations

import argparse
import json

import pytest

from k8s_operator_libs_tpu_torch.__main__ import (
    _parse_selector_arg,
    _positive_float,
    main as cli_main,
)
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


class TestArgValidators:
    def test_positive_float_accepts_positive(self):
        assert _positive_float("2.5") == 2.5

    def test_positive_float_rejects_zero_and_negative(self):
        for raw in ("0", "-1"):
            with pytest.raises(argparse.ArgumentTypeError, match="> 0"):
                _positive_float(raw)

    def test_selector_parses_terms_and_skips_blanks(self):
        assert _parse_selector_arg("a=1, b=2,,") == {"a": "1", "b": "2"}

    def test_selector_rejects_termless_fragment(self):
        with pytest.raises(SystemExit, match="key=value"):
            _parse_selector_arg("oops")


class TestExitCodeConventions:
    def _patch_func(self, monkeypatch, exc):
        """Route a minimal subcommand to a function raising *exc*."""

        def boom(args):
            raise exc

        import k8s_operator_libs_tpu_torch.__main__ as m

        monkeypatch.setattr(m, "cmd_status", boom)
        return ["status", "--state-file", "/nonexistent"]

    def test_broken_pipe_exits_141(self, monkeypatch):
        import io
        import sys as _sys

        argv = self._patch_func(monkeypatch, BrokenPipeError())
        # the handler closes sys.stderr (so the interpreter's shutdown
        # flush cannot re-raise into the dead pipe); give it a
        # sacrificial stream, not pytest's
        monkeypatch.setattr(_sys, "stderr", io.StringIO())
        assert cli_main(argv) == 141

    def test_keyboard_interrupt_exits_130(self, monkeypatch):
        argv = self._patch_func(monkeypatch, KeyboardInterrupt())
        assert cli_main(argv) == 130


class TestStatusSourceErrors:
    def test_missing_state_file_fails_cleanly(self, tmp_path, capsys):
        rc = cli_main(
            ["status", "--state-file", str(tmp_path / "absent.json")]
        )
        assert rc != 0

    def test_unknown_policy_degrades_to_ungated_status(self, tmp_path, capsys):
        """A missing policy must not kill `status` — it reports the miss,
        skips gate evaluation, and still renders (rc by rollout state)."""
        from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(InMemoryCluster().to_dict()))
        rc = cli_main(
            ["status", "--state-file", str(path), "--policy", "nope"]
        )
        out = capsys.readouterr()
        combined = out.err + out.out
        assert rc == 0
        assert "not found" in combined
        assert "gates not evaluated" in combined

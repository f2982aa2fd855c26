"""The port's examples (``k8s_operator_libs_tpu_torch/examples/``
``rolling_upgrade``, ``requestor_mode`` and ``federation_demo``) and its
federation self-test, each beside the JAX package's.

Each example runs as a subprocess on both packages, and the port's
standard output equals the JAX one after ``to_port_vocab``: line for
line where it is deterministic (the one wall time the requestor demo
prints is masked), and as a multiset of lines for the federation demo,
whose cells' event lines interleave by thread timing on both packages.  The
federation self-test builds three harness cells on ``SimFleet`` and
asserts its own outcome: each package's must pass.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

ROOT = Path(__file__).resolve().parent.parent


def _stdout(argv) -> str:
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return re.sub(r"\d+\.\d+s\b", "<wall>s", proc.stdout)


@pytest.mark.parametrize("example,args", [
    ("rolling_upgrade", []),
    ("requestor_mode", []),
    ("federation_demo", []),
    ("federation_demo", ["--breach"]),
], ids=["rolling_upgrade", "requestor_mode", "federation_demo", "federation_demo-breach"])
def test_each_example_prints_what_the_jax_one_prints(example, args):
    jax = to_port_vocab(_stdout([sys.executable, f"examples/{example}.py", *args]))
    port = _stdout([sys.executable, "-m", f"k8s_operator_libs_tpu_torch.examples.{example}", *args])
    if example == "federation_demo":
        jax, port = sorted(jax.splitlines()), sorted(port.splitlines())
    assert port == jax
    assert port


def test_the_federation_selftest_passes_on_both_packages():
    from k8s_operator_libs_tpu.federation import selftest as jselftest
    from k8s_operator_libs_tpu_torch.federation import selftest

    assert jselftest.selftest()
    assert selftest.selftest()

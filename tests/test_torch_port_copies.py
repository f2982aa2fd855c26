"""The control-plane modules the port copies hold exact to the JAX package.

Each module below is the JAX module of the same relative path, in the
GPU-fleet vocabulary: after every string constant of the JAX module is
rewritten by :func:`test_torch_vocab.to_port_vocab`, and with every
docstring dropped from both, the two parse to the same syntax tree.  So
every branch of the JAX module, tested or not, is in the port, and an
edit to either package that the other lacks fails here.
:class:`CheckpointDrainGate` is held the same way, as a class of its
module (the port's module also holds its own ``DrainSignalWatcher``), and
the port's test harness, ``tests/test_torch_harness.py``, as
``tests/harness.py`` with its absolute imports of the JAX package mapped
onto the port.
"""

import ast
from pathlib import Path

import pytest

from test_torch_vocab import to_port_vocab

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE, PORT_PACKAGE = ROOT / "k8s_operator_libs_tpu", ROOT / "k8s_operator_libs_tpu_torch"

COPIED_MODULES = (
    "upgrade/node_upgrade_state_provider.py",
    "upgrade/cordon_manager.py",
    "upgrade/drain_manager.py",
    "upgrade/pod_manager.py",
    "upgrade/validation_manager.py",
    "upgrade/safe_driver_load_manager.py",
    "upgrade/common_manager.py",
    "upgrade/upgrade_inplace.py",
    "obs/slo.py",
    "upgrade/analysis.py",
    "upgrade/remediation.py",
    "upgrade/rollout_status.py",
    "runtime.py",
    "upgrade/state_index.py",
    "upgrade/upgrade_requestor.py",
    "upgrade/upgrade_state.py",
    "upgrade/plan.py",
)
COPIED_CLASSES = (("tpu/drain_handshake.py", "CheckpointDrainGate"),)


class _Normalise(ast.NodeTransformer):
    """Drops docstrings; with *rewrite*, maps string constants into the
    port's vocabulary and absolute imports of the JAX package onto the
    port's."""

    def __init__(self, rewrite: bool):
        self.rewrite = rewrite

    def _drop_docstring(self, node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) and isinstance(
                body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        self.generic_visit(node)
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _drop_docstring

    def visit_Constant(self, node):
        if self.rewrite and isinstance(node.value, str):
            node.value = to_port_vocab(node.value)
        return node

    def visit_ImportFrom(self, node):
        if self.rewrite and node.level == 0 and node.module:
            head, dot, rest = node.module.partition(".")
            if head == JAX_PACKAGE.name:
                node.module = PORT_PACKAGE.name + dot + rest
        return node


def _tree(path: Path, rewrite: bool, class_name: str = "") -> str:
    tree = ast.parse(path.read_text())
    if class_name:
        [tree] = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == class_name]
    return ast.dump(_Normalise(rewrite).visit(tree))


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_the_ported_module_is_the_jax_module(module):
    assert _tree(JAX_PACKAGE / module, rewrite=True) == _tree(PORT_PACKAGE / module, rewrite=False)


@pytest.mark.parametrize("module,class_name", COPIED_CLASSES)
def test_the_ported_class_is_the_jax_class(module, class_name):
    assert _tree(JAX_PACKAGE / module, True, class_name) == _tree(PORT_PACKAGE / module, False, class_name)


def test_the_port_harness_is_the_jax_harness():
    """tests/test_torch_harness.py is tests/harness.py on the port."""
    tests = ROOT / "tests"
    assert _tree(tests / "harness.py", rewrite=True) == _tree(tests / "test_torch_harness.py", rewrite=False)


def test_the_import_mapping_takes_only_the_package_name():
    mapped = ast.dump(_Normalise(True).visit(ast.parse("from k8s_operator_libs_tpu.upgrade import plan")))
    assert mapped == ast.dump(ast.parse("from k8s_operator_libs_tpu_torch.upgrade import plan"))
    for other in ("from k8s_operator_libs_tpux import plan", "from .upgrade import plan"):
        assert ast.dump(_Normalise(True).visit(ast.parse(other))) == ast.dump(ast.parse(other))


def test_the_normalisation_sees_a_one_token_edit():
    """A renamed function or a changed string is a different tree; a
    changed docstring or comment is not."""
    source = (JAX_PACKAGE / "upgrade/cordon_manager.py").read_text()
    base = ast.dump(_Normalise(False).visit(ast.parse(source)))
    for edited in (source.replace("def ", "def _", 1), source.replace('"Node"', '"Nodes"', 1)):
        assert edited != source
        assert ast.dump(_Normalise(False).visit(ast.parse(edited))) != base
    commented = source.replace('"""', '""" edited', 1) + "\n# a comment\n"
    assert ast.dump(_Normalise(False).visit(ast.parse(commented))) == base

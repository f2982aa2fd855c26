"""The control-plane modules the port copies hold exact to the JAX package.

Each module below is the JAX module of the same relative path, in the
GPU-fleet vocabulary: after every string constant of the JAX module is
rewritten by :func:`test_torch_vocab.to_port_vocab`, and with every
docstring dropped from both, the two parse to the same syntax tree.  So
every branch of the JAX module, tested or not, is in the port, and an
edit to either package that the other lacks fails here.  The named
exceptions: :data:`MOVED_IMPORTS` (the port's ``crdutil`` imports PyYAML
inside the one function that parses YAML), :data:`RENAMED_STRINGS` (the
CLI's logger, ``prog`` and the ratchet file's help text name the port's
package) and :data:`RATCHET_PATH` (the chaos search reads its ratchet file
from inside the port's package, not from the repository's root).
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
    "controller/__init__.py",
    "controller/workqueue.py",
    "controller/wakeup.py",
    "controller/leader_election.py",
    "controller/controller.py",
    "controller/ha.py",
    "controller/ops_server.py",
    "controller/upgrade_reconciler.py",
    "obs/__init__.py",
    "obs/overhead.py",
    "obs/racewatch.py",
    "obs/profiling.py",
    "crdutil/__init__.py",
    "crdutil/crdutil.py",
    "api/__init__.py",
    "api/federation_spec.py",
    "federation/__init__.py",
    "federation/coordinator.py",
    "upgrade/chaos.py",
    "upgrade/chaossearch.py",
    "upgrade/__init__.py",
    "federation/selftest.py",
    "__main__.py",
)
#: The one named exception: the port's crdutil imports PyYAML inside
#: ``parse_crds_from_file``, where the JAX module imports it at module
#: level, so that the port imports without PyYAML.  Each side's import
#: is checked where it stands, then dropped from both trees.
MOVED_IMPORTS = {"crdutil/crdutil.py": ("yaml", "parse_crds_from_file")}
#: Whole string constants of a JAX module that name the JAX package
#: where the port's must name its own, with how many times each stands:
#: the CLI's logger (a verbatim copy would name no parent of the port's
#: loggers and silence nothing), its ``prog`` and the ratchet file's
#: place in the ``--record`` help text.
RENAMED_STRINGS = {
    "__main__.py": {
        "k8s_operator_libs_tpu": ("k8s_operator_libs_tpu_torch", 1),
        "python -m k8s_operator_libs_tpu": ("python -m k8s_operator_libs_tpu_torch", 1),
        "search mode: append each shrunk reproducer to the regression-cell file (implies "
        "--shrink; default PATH: hack/chaos_regressions.json, replayed by the default campaign)": (
            "search mode: append each shrunk reproducer to the regression-cell file (implies "
            "--shrink; default PATH: k8s_operator_libs_tpu_torch/hack/chaos_regressions.json, "
            "replayed by the default campaign)", 1),
    },
}
#: The chaos search's ratchet file: the JAX module reads the repository
#: root's ``hack/chaos_regressions.json`` (``parents[2]``), the port its
#: own copy in the package (``parents[1]``).  Module, assigned name, and
#: the ``parents`` index on each side.
RATCHET_PATH = ("upgrade/chaossearch.py", "DEFAULT_REGRESSIONS_PATH", 2, 1)
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


def _is_import(node, name: str) -> bool:
    return isinstance(node, ast.Import) and [a.name for a in node.names] == [name]


def _drop_moved_import(tree: ast.Module, module: str, in_jax: bool) -> None:
    """Remove :data:`MOVED_IMPORTS`' import of *module*: from the JAX
    module's top level, or from the head of the port's function."""
    name, function = MOVED_IMPORTS[module]
    if in_jax:
        body = tree.body
    else:
        [fn] = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function]
        body = fn.body
    moved = [i for i, n in enumerate(body) if _is_import(n, name)]
    assert len(moved) == 1, (module, in_jax)
    if not in_jax:  # right after the docstring, before any other statement
        assert moved == [1], moved
    del body[moved[0]]
    assert not any(_is_import(n, name) for n in ast.walk(tree))


def _rename_strings(tree: ast.Module, module: str) -> None:
    """Rewrite :data:`RENAMED_STRINGS`' constants of the JAX *module* to
    the port's, each exactly as many times as it stands there."""
    renames = RENAMED_STRINGS[module]
    seen = dict.fromkeys(renames, 0)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value in renames:
            seen[node.value] += 1
            node.value = renames[node.value][0]
    assert seen == {old: n for old, (_, n) in renames.items()}, (module, seen)


def _ratchet_index(tree: ast.Module, in_jax: bool) -> None:
    """Check :data:`RATCHET_PATH`'s ``parents`` index where it stands on
    each side, and set the JAX one to the port's."""
    _, name, jax_index, port_index = RATCHET_PATH
    [assign] = [n for n in tree.body if isinstance(n, ast.Assign)
                and [t.id for t in n.targets if isinstance(t, ast.Name)] == [name]]
    [index] = [n.slice for n in ast.walk(assign)
               if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Attribute)
               and n.value.attr == "parents"]
    assert index.value == (jax_index if in_jax else port_index), (in_jax, index.value)
    index.value = port_index


def _tree(path: Path, rewrite: bool, class_name: str = "", moved: str = "",
          module: str = "") -> str:
    tree = ast.parse(path.read_text())
    if moved:
        _drop_moved_import(tree, moved, in_jax=rewrite)
    if rewrite and module in RENAMED_STRINGS:
        _rename_strings(tree, module)
    if module == RATCHET_PATH[0]:
        _ratchet_index(tree, in_jax=rewrite)
    if class_name:
        [tree] = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == class_name]
    return ast.dump(_Normalise(rewrite).visit(tree))


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_the_ported_module_is_the_jax_module(module):
    moved = module if module in MOVED_IMPORTS else ""
    assert _tree(JAX_PACKAGE / module, True, moved=moved, module=module) == _tree(
        PORT_PACKAGE / module, False, moved=moved, module=module)


@pytest.mark.parametrize("module", sorted(RENAMED_STRINGS) + [RATCHET_PATH[0]])
def test_the_named_exceptions_are_the_differences(module):
    """Without its exception each such module differs from the JAX one."""
    assert _tree(JAX_PACKAGE / module, rewrite=True) != _tree(PORT_PACKAGE / module, rewrite=False)


def test_the_ratchet_file_is_the_jax_one_in_the_port_vocabulary():
    """The port's shipped ratchet file, where its chaos search reads it."""
    import json

    from k8s_operator_libs_tpu_torch.upgrade import chaossearch

    path = chaossearch.DEFAULT_REGRESSIONS_PATH
    assert path == PORT_PACKAGE / "hack" / "chaos_regressions.json"
    jax_cells = json.loads((ROOT / "hack" / "chaos_regressions.json").read_text())
    assert json.loads(path.read_text()) == to_port_vocab(jax_cells)


def test_the_moved_import_is_the_one_difference():
    """Without the exception the crdutil trees differ, and the port's
    module holds no module-level yaml import."""
    module = "crdutil/crdutil.py"
    assert _tree(JAX_PACKAGE / module, rewrite=True) != _tree(PORT_PACKAGE / module, rewrite=False)
    port = ast.parse((PORT_PACKAGE / module).read_text())
    assert not any(_is_import(n, "yaml") for n in port.body)


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

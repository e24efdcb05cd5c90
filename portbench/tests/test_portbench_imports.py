"""No module the benchmark runs imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole: zelana_tpu_torch is not
zelana_tpu), and the reference imports nothing of the program."""

import ast
import os

import pytest

from portbench.harness import HERE, JAX_NAMES


def modules(sub=""):
    base = os.path.join(HERE, sub)
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


def hooked(path) -> set:
    """The modules a metric's HOOKS name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "HOOKS"):
            return {t.elts[0].value.split(".")[0] for t in node.value.elts}
    return set()


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    found = (imported(path) | hooked(path)) & set(JAX_NAMES)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(modules("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_stands_alone(path):
    assert not imported(path) & {"zelana_tpu_torch", "zelana_tpu", "torch",
                                 "chip_smoke", "tools"}


def test_whole_names_compared(monkeypatch):
    import sys

    from portbench.harness import jax_modules

    monkeypatch.setitem(sys.modules, "zelana_tpu_torch_fake", object())
    assert "zelana_tpu_torch_fake" not in jax_modules()
    monkeypatch.setitem(sys.modules, "zelana_tpu.fake", object())
    assert "zelana_tpu.fake" in jax_modules()

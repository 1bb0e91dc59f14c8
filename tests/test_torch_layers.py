"""The port's layers point one way, and each test worker gets its share of
the cores.

* Imports, read from the port's sources with ``ast``: no module of the
  lower layers imports the trainers or the serving entry point, the
  trainers do not import the serving entry point, and the DiT trainer
  takes nothing from the VAE trainer (what both need is in
  ``training/loop.py``, ``avatar.py`` and ``models/init.py``).
* Under pytest-xdist, the rootdir ``conftest.py`` sizes the worker's torch
  and OpenMP pools to its share of the cores.
"""

import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "sigman_release_torch")
PKG = "sigman_release_torch"
TRAINING, INFERENCE = f"{PKG}.training", f"{PKG}.inference"


def _sources(rel: str):
    """The .py files of the port under ``rel`` (a directory or a file)."""
    path = os.path.join(PORT, rel)
    if path.endswith(".py"):
        return [path]
    return [os.path.join(d, n) for d, _, names in os.walk(path)
            for n in names if n.endswith(".py")]


def _imports(path: str) -> set:
    """Every module ``path`` imports, anywhere in the file, as a dotted
    name; ``from a import b`` counts as ``a`` and ``a.b``."""
    name = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    package = name.rsplit(".", 1)[0]
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.rsplit(".", node.level - 1)[0]
                base = f"{parent}.{base}" if base else parent
            found.add(base)
            found.update(f"{base}.{a.name}" for a in node.names)
    return found


def _reaches(module: str, target: str) -> bool:
    return module == target or module.startswith(target + ".")


@pytest.mark.parametrize("layer, forbidden", [
    pytest.param(layer, forbidden, id=layer) for layer, forbidden in (
        *[(d, (TRAINING, INFERENCE)) for d in (
            "models", "ops", "body", "parallel", "diffusion", "losses",
            "data", "utils")],
        ("training", (INFERENCE,)),
        ("avatar.py", (TRAINING, INFERENCE)),
        ("training/dit_trainer.py", (f"{TRAINING}.vae_trainer",)))])
def test_layers_import_only_downwards(layer, forbidden):
    files = _sources(layer)
    assert files, layer
    wrong = sorted((os.path.relpath(f, ROOT), m) for f in files
                   for m in _imports(f)
                   if any(_reaches(m, t) for t in forbidden))
    assert not wrong, wrong


def test_each_xdist_worker_gets_its_share_of_the_cores(request):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        pytest.skip("not a pytest-xdist worker: the thread pools are left "
                    "as they are")
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    root = [p for p in request.config.pluginmanager.get_plugins()
            if getattr(p, "__file__", None) == os.path.join(ROOT,
                                                            "conftest.py")]
    assert len(root) == 1, "the rootdir conftest.py is not loaded"
    assert root[0].worker_threads() == share
    assert torch.get_num_threads() == share
    assert os.environ["OMP_NUM_THREADS"] == str(share)

"""hairpt_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax, the JAX package or PIL (the machine with the
card has no imaging library: the port codes its images itself, and the
new modules of utils/ and core/ are cases here too); nothing of the port loads
the JAX package's prebuilt library; chip_smoke.py refuses to run without
a CUDA card, quickly and without printing a result."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hairpt_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        if "_build" in root:
            continue
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
            elif node.level > 0:
                # relative imports must stay inside the port package
                base = os.path.relpath(os.path.dirname(path), REPO)
                parts = base.split(os.sep)
                up = parts[:len(parts) - (node.level - 1)]
                yield ".".join(up + ([node.module] if node.module else []))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_hairpt_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "hairpt", "PIL"), (path, mod)


def test_port_never_touches_the_jax_packages_library():
    for path in _port_files():
        src = open(path).read()
        assert "libhairpt_bvh.so" not in src, path
        assert "-march=native" not in src, path


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=60)


def test_chip_smoke_without_a_card_exits_nonzero():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

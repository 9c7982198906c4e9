"""Rules of the port: it never imports JAX or the JAX package, its entry
points default to the GPU and raise without one, and its copies of the JAX
package's JAX-free modules differ from them only in comments and
docstrings."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import mplan2vdl_tpu
import mplan2vdl_tpu_torch

PORT = os.path.dirname(mplan2vdl_tpu_torch.__file__)
JAXPKG = os.path.dirname(mplan2vdl_tpu.__file__)
REPO = os.path.dirname(PORT)

# modules copied from the JAX package, at the same relative paths
COPIED = ["names.py", "mtypes.py", "fe/__init__.py", "fe/lexer.py",
          "fe/plan_parser.py", "fe/schema_parser.py", "catalog.py",
          "mplan.py", "vir.py", "passes.py", "engine/columnstore.py",
          "engine/datagen.py", "engine/nativeio.py", "oracle/__init__.py",
          "oracle/tpch.py", "engine/fuse.py", "fe/tree_parser.py", "dot.py",
          "vdl_emit.py", "explain.py", "engine/tblingest.py"]
# top-level definitions the port leaves out of a copy, with the reason
OMITTED = {
    # it caches stores under a fixed directory in the user's home; the
    # port reads and writes nothing outside the caller's own paths
    "engine/datagen.py": {"cached_store"},
}


def _banned(mod: str) -> bool:
    """jax, or the JAX package itself (not the port, whose name it
    prefixes)."""
    return (mod == "jax" or mod.startswith("jax.")
            or mod == "mplan2vdl_tpu" or mod.startswith("mplan2vdl_tpu."))


def _port_modules():
    names = ["mplan2vdl_tpu_torch"]
    for m in pkgutil.walk_packages([PORT], "mplan2vdl_tpu_torch."):
        if not m.name.endswith("__main__"):
            names.append(m.name)
    return names


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    code = (
        "import importlib, json, sys\n"
        f"names = {_port_modules()!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert len(_port_modules()) > 25
    assert "mplan2vdl_tpu_torch.engine.lower" in loaded
    for mod in ("engine.kernels.multiagg_mxu", "engine.kernels.radix_rank",
                "engine.kernels.probes", "tools.probe_radix",
                "tools.probe_kernels", "cli", "fe.tree_parser", "dot",
                "vdl_emit", "explain", "engine.tblingest",
                "parallel.multihost", "parallel.dist", "parallel.shuffle_agg",
                "parallel.shuffle_join"):
        assert f"mplan2vdl_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _banned(m)] == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_source_scan_finds_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 25
    # the command line and every copied module are among the files scanned
    for rel in ["cli.py"] + COPIED:
        assert os.path.join(PORT, rel) in files, rel
    bad = [(f, m) for f in files for m in _imports(f) if _banned(m)]
    assert bad == []


def test_prefix_rule():
    assert _banned("mplan2vdl_tpu") and _banned("mplan2vdl_tpu.engine")
    assert _banned("jax") and _banned("jax.numpy")
    assert not _banned("mplan2vdl_tpu_torch")
    assert not _banned("mplan2vdl_tpu_torch.engine.lower")
    assert not _banned("jaxtyping")


def test_default_device_raises_without_cuda(monkeypatch):
    from mplan2vdl_tpu_torch import device
    from mplan2vdl_tpu_torch.engine import datagen
    from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, plan_to_vexps

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = datagen.generate(sf=0.002, seed=1)
    cfg = store.make_catalog()
    vexps = plan_to_vexps(chip_smoke.PLAN_Q6, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledQuery(cfg, vexps, store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledQuery(cfg, vexps, store, device="cuda")
    assert CompiledQuery(cfg, vexps, store, device="cpu").device.type == "cpu"
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        device.resolve()


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def _stripped(path, omit=()):
    """The module's AST without docstrings (and without ``omit``'s
    top-level definitions), dumped."""
    tree = ast.parse(open(path).read(), path)
    tree.body = [n for n in tree.body
                 if getattr(n, "name", None) not in omit]
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_in_sync_with_jax_module(rel):
    omit = OMITTED.get(rel, set())
    got = _stripped(os.path.join(PORT, rel))
    want = _stripped(os.path.join(JAXPKG, rel), omit)
    assert got == want, f"{rel} drifted from mplan2vdl_tpu/{rel}"
    if omit:
        assert _stripped(os.path.join(JAXPKG, rel)) != want

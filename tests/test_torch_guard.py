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
          "vdl_emit.py", "explain.py", "engine/tblingest.py",
          "oracle/relinterp.py"]
# definitions a copy rewrites, each with its reason: a top-level name, a
# method as "Class.method", or an import as "import <module>"; every other
# definition of the module is compared as it stands
REWRITTEN = {
    "oracle/relinterp.py": {
        "Interp._join": "pandas is not installed where the port runs",
        "import pandas": "pandas is not installed where the port runs "
                         "(Interp._join was its one user)",
    },
    "engine/datagen.py": {
        "cached_store": "its default cache directory is a fixed path in "
                        "the user's home; the port reads and writes "
                        "nothing outside the caller's own paths, so the "
                        "copy takes cache_root from its caller (keyword "
                        "only, no default) and keeps the body",
    },
}
# definitions only the port's copy has, each serving a rewritten one
ADDED = {
    # Interp._join's numpy pairing, in pandas' merge order
    "oracle/relinterp.py": {"equi_join_pairs", "_ascending", "_first_labels",
                            "_pandas_keys", "_pandas_one_to_one_order"},
}

def _banned(mod: str) -> bool:
    """jax, the JAX package itself (not the port, whose name it
    prefixes), or pandas, which is not installed where the port runs."""
    return (mod == "jax" or mod.startswith("jax.")
            or mod == "mplan2vdl_tpu" or mod.startswith("mplan2vdl_tpu.")
            or mod == "pandas" or mod.startswith("pandas."))

def _port_modules():
    names = ["mplan2vdl_tpu_torch"]
    for m in pkgutil.walk_packages([PORT], "mplan2vdl_tpu_torch."):
        if not m.name.endswith("__main__"):
            names.append(m.name)
    return names


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest): the
    port's modules and the plans and oracles the tests share with
    chip_smoke.py (tests/torch_plans.py)."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        f"names = {_port_modules()!r} + ['torch_plans']\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert len(_port_modules()) > 25
    assert "mplan2vdl_tpu_torch.engine.lower" in loaded
    assert "torch_plans" in loaded and "chip_smoke" not in loaded
    for mod in ("engine.kernels.multiagg_mxu", "engine.kernels.radix_rank",
                "engine.kernels.probes", "tools.probe_radix",
                "tools.probe_kernels", "cli", "fe.tree_parser", "dot",
                "vdl_emit", "explain", "engine.tblingest",
                "parallel.multihost", "parallel.dist", "parallel.shuffle_agg",
                "parallel.shuffle_join", "oracle.relinterp"):
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
    # chip_smoke.py imports the census plans and the shared plans and
    # oracles on the card
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_census_cases.py"),
             os.path.join(REPO, "tests", "torch_plans.py")]
    for root, _, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 25
    # the command line and every copied module are among the files scanned
    for rel in ["cli.py"] + COPIED:
        assert os.path.join(PORT, rel) in files, rel
    bad = [(f, m) for f in files for m in _imports(f) if _banned(m)]
    assert bad == []


# the tests of chip_smoke.py's own phases; every other test module takes
# the plans and oracles from tests/torch_plans.py
CARD_PHASE_TESTS = {"test_torch_census.py", "test_torch_auto_dist.py",
                    "test_torch_parallel.py", "test_torch_guard.py"}


def test_only_the_card_phase_tests_import_chip_smoke():
    tests = os.path.join(REPO, "tests")
    files = sorted(f for f in os.listdir(tests) if f.endswith(".py"))
    assert "torch_plans.py" in files and len(files) > 50
    importers = {f for f in files
                 if "chip_smoke" in _imports(os.path.join(tests, f))}
    assert importers <= CARD_PHASE_TESTS, sorted(importers - CARD_PHASE_TESTS)


def test_prefix_rule():
    assert _banned("mplan2vdl_tpu") and _banned("mplan2vdl_tpu.engine")
    assert _banned("jax") and _banned("jax.numpy")
    assert not _banned("mplan2vdl_tpu_torch")
    assert not _banned("mplan2vdl_tpu_torch.engine.lower")
    assert not _banned("jaxtyping")
    assert _banned("pandas") and _banned("pandas.core.reshape.merge")
    assert not _banned("pandasql_like")


def test_default_device_raises_without_cuda(monkeypatch):
    from mplan2vdl_tpu_torch import device
    from mplan2vdl_tpu_torch.engine import datagen
    from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, plan_to_vexps

    import torch_plans

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = datagen.generate(sf=0.002, seed=1)
    cfg = store.make_catalog()
    vexps = plan_to_vexps(torch_plans.PLAN_Q6, cfg)
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


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _name(node) -> str:
    """A top-level statement's name in REWRITTEN and ADDED."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Import):
        return " ".join("import " + a.name for a in node.names)
    return ast.dump(node)


def _definitions(path):
    """The module's top-level statements in order, docstrings removed, as
    (name, AST dump) pairs; a class's methods follow it as
    ("Class.method", dump) entries, and its own entry holds the rest of
    its body."""
    tree = _strip_docstrings(ast.parse(open(path).read(), path))
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            methods = [b for b in node.body
                       if isinstance(b, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            node.body = [b for b in node.body if b not in methods]
            out.append((node.name, ast.dump(node)))
            out += [(f"{node.name}.{m.name}", ast.dump(m)) for m in methods]
        else:
            out.append((_name(node), ast.dump(node)))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copy_in_sync_with_jax_module(rel):
    """Definition by definition, at method level inside classes: the copy
    equals the JAX module but for the definitions REWRITTEN names, and the
    ones ADDED names, which the JAX module lacks."""
    rewritten = REWRITTEN.get(rel, {})
    added = ADDED.get(rel, set())
    got = _definitions(os.path.join(PORT, rel))
    want = _definitions(os.path.join(JAXPKG, rel))
    assert ([d for d in got if d[0] not in rewritten and d[0] not in added]
            == [d for d in want if d[0] not in rewritten]), \
        f"{rel} drifted from mplan2vdl_tpu/{rel}"
    # each exemption names a definition that is really rewritten or added
    want_names = dict(want)
    for name in rewritten:
        assert name in want_names, name
        assert dict(got).get(name) != want_names[name], name
    for name in added:
        assert name in dict(got) and name not in want_names, name


def test_cached_store_rewrites_only_its_signature():
    """datagen.cached_store: the body is the JAX one; the cache directory
    has no default."""
    import inspect

    from mplan2vdl_tpu.engine import datagen as jdatagen
    from mplan2vdl_tpu_torch.engine import datagen as tdatagen

    def body(fn):
        tree = _strip_docstrings(ast.parse(
            inspect.cleandoc("\n" + inspect.getsource(fn))))
        return [ast.dump(n) for n in tree.body[0].body]

    assert body(tdatagen.cached_store) == body(jdatagen.cached_store)
    sig = inspect.signature(tdatagen.cached_store)
    assert sig.parameters["cache_root"].default is inspect.Parameter.empty
    assert (sig.parameters["cache_root"].kind
            is inspect.Parameter.KEYWORD_ONLY)


def test_cached_store_round_trip(tmp_path):
    """The copy's cache: a missing directory is generated and saved, a
    saved one is loaded, a corrupt one is generated again."""
    import numpy as np

    from mplan2vdl_tpu_torch.engine import datagen

    root = str(tmp_path)
    a = datagen.cached_store(0.001, seed=3, cache_root=root)
    cache = os.path.join(root, "mplan2vdl_store_sf0.001_seed3")
    assert os.path.isdir(cache)
    b = datagen.cached_store(0.001, seed=3, cache_root=root)
    key = ("lineitem", "l_orderkey")
    assert np.array_equal(a.columns[key], b.columns[key])
    # a half-written column: shorter than the manifest says
    with open(os.path.join(cache, "lineitem.l_orderkey.bin"), "wb") as f:
        f.write(b"\0" * 8)
    c = datagen.cached_store(0.001, seed=3, cache_root=root)
    assert np.array_equal(a.columns[key], c.columns[key])

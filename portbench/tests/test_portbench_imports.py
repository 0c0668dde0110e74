"""Import guards: the harness loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``tpuseg`` (whole names: ``tpuseg_torch``
is the program), and the plain references import nothing of the program,
of ``tpuseg`` or of JAX."""
import ast
import json
import subprocess
import sys

from portbench import core

REFERENCE_FORBIDDEN = {"tpuseg_torch", "tpuseg", "jax", "jaxlib", "flax"}


def test_harness_imports_load_no_jax_or_tpuseg():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(core.ROOT)!r})\n"
        "from portbench import core, costs, inputs\n"
        "import portbench.run\n"
        "manifest = json.load(open(core.ROOT / 'BENCHMARK.json'))\n"
        "for w in manifest['workloads']:\n"
        "    c = core.cell(w['name'])\n"
        "    c.reference(); c.driver()\n"
        "    for m in c.per_layer: c.reader(m['name'])\n"
        "import tpuseg_torch.train.loop, tpuseg_torch.evaluation.inference\n"
        "import tpuseg_torch.kernels.ocr_attention\n"
        "import tpuseg_torch.kernels.bottleneck_fused\n"
        "print(json.dumps(core.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuseg_torch_like", sys)
    assert "tpuseg" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in core.forbidden_modules()


def test_references_import_nothing_of_the_program():
    files = sorted((core.HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in REFERENCE_FORBIDDEN, (f, n)
        assert "importlib" not in f.read_text(), f

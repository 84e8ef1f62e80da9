"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names compared whole
(``sgmse_tpu_torch`` begins with ``sgmse_tpu`` and is the port)."""
import ast
import subprocess
import sys

from conftest import ROOT

from portbench import harness

HERE = harness.HERE


def imported(path):
    """Top-level names of every module that ``path`` imports (absolute ones)."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = imported(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "sgmse_tpu_torch" not in imported(path), path
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.nets, "
            "portbench.reference.enhance, portbench.reference.training, "
            "portbench.reference.loader_check, portbench.reference.compare, "
            "portbench.counts.network, portbench.counts.kernels; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"sgmse_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"sgmse_tpu_torch": 1, "sgmse_tpu_torch.model": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"sgmse_tpu.model": 1, "jax.numpy": 1, "flax": 1, "jaxlib": 1})
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib", "sgmse_tpu.model"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "sgmse-plus-16k.enhance-b16", "--seed", str(2 ** 31 + 11),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""

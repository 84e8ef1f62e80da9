"""The port runs where JAX does not exist: no module of sgmse_tpu_torch imports
jax, flax or sgmse_tpu, at import time or in its source."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "sgmse_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "sgmse_tpu")


def test_entry_point_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import sgmse_tpu_torch, sgmse_tpu_torch.enhance, sgmse_tpu_torch.convert\n"
        "import sgmse_tpu_torch.kernels, sgmse_tpu_torch.ops.upfirdn2d\n"
        "import sgmse_tpu_torch.ops.group_norm, sgmse_tpu_torch.train\n"
        "import sgmse_tpu_torch.checkpoint, sgmse_tpu_torch.data.dataset\n"
        "import sgmse_tpu_torch.utils.metrics, sgmse_tpu_torch.utils.p862\n"
        "import sgmse_tpu_torch.utils.loggers, sgmse_tpu_torch.utils.inference\n"
        "import sgmse_tpu_torch.utils.pesq_loss, sgmse_tpu_torch.data.native\n"
        "import sgmse_tpu_torch.kernel_times, sgmse_tpu_torch.nfe_profile\n"
        "import sgmse_tpu_torch.models.dcunet, sgmse_tpu_torch.serve\n"
        "import sgmse_tpu_torch.parallel.dist, sgmse_tpu_torch.parallel.rows\n"
        "import sgmse_tpu_torch.parallel.pool, sgmse_tpu_torch.calc_metrics\n"
        "import sgmse_tpu_torch.data.room, sgmse_tpu_torch.utils.profiling\n"
        "import sgmse_tpu_torch.preprocessing.mixing\n"
        "import sgmse_tpu_torch.preprocessing.create_synthetic_speech\n"
        "import sgmse_tpu_torch.preprocessing.create_wsj0_chime3\n"
        "import sgmse_tpu_torch.preprocessing.create_wsj0_qut\n"
        "import sgmse_tpu_torch.preprocessing.create_wsj0_reverb\n"
        "import sgmse_tpu_torch.tools.learn_demo, sgmse_tpu_torch.tools.bf16_quality\n"
        "import sgmse_tpu_torch.tools.quality_vs_nfe\n"
        "import sgmse_tpu_torch.tools.learn_demo_reverb, sgmse_tpu_torch.tools.learn_demo_48k\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"

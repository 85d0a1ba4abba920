"""Nothing of the benchmark imports JAX or the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "handwritten_ocr_tpu"}


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): imported_top_levels(f) & FORBIDDEN
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_harness_and_its_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.harness, benchmark.drivers.ocr,"
            " benchmark.reference.models;"
            "import handwritten_ocr_tpu_torch.engine.torch_engines;"
            "from benchmark.harness import forbidden_modules;"
            "print(forbidden_modules())") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_the_top_level_check_tells_the_port_from_the_jax_package():
    from benchmark.harness import forbidden_modules
    assert forbidden_modules(["handwritten_ocr_tpu_torch.ops.bank",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["handwritten_ocr_tpu.models", "jax.numpy",
                              "flax"]) == ["flax", "handwritten_ocr_tpu",
                                           "jax"]

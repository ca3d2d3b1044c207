"""What the benchmark imports and reads: never jax, the JAX package or
its benchmark files."""

import re
import subprocess
import sys

from benchmark.catalog import HERE, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "seal_embedded_tpu"}

PROBE = """
import sys
sys.path.insert(0, {repo!r})
import runpy
runpy.run_path({run!r}, run_name="benchmark_run")
import benchmark.harness, benchmark.control, benchmark.device
from benchmark.catalog import Catalog
c = Catalog()
for name in c.metric_files():
    c.reader(name)
for form in c.wire_files():
    c.wire(form)
import seal_embedded_tpu_torch.api, seal_embedded_tpu_torch.ckks.stream
import seal_embedded_tpu_torch.graphs
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    return set(out.stdout.split())


def test_the_run_imports_no_jax_nor_the_jax_package():
    tops = loaded_top_levels(PROBE.format(repo=str(REPO),
                                          run=str(HERE / "run.py")))
    assert "seal_embedded_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "bench" not in tops


def test_the_reference_imports_nothing_of_the_program():
    tops = loaded_top_levels(
        f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
        "import benchmark.reference.ckks, benchmark.check\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not tops & (FORBIDDEN | {"seal_embedded_tpu_torch", "torch"})


def test_no_harness_file_reads_the_jax_packages_benchmark_files():
    pattern = re.compile(r"bench\.py|BENCH_|BASELINE\.json|MULTICHIP_")
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        assert not pattern.search(path.read_text()), path


def test_the_run_refuses_a_machine_without_a_card():
    """No card: a non-zero exit and no result line (this machine has none,
    or the test is moot)."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(HERE / "run.py"),
                          "--workload", "n4096.sym.b16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_forbidden_names_are_compared_whole():
    from benchmark.harness import forbidden_modules
    sys.modules.setdefault("seal_embedded_tpu_torch_probe", sys)
    try:
        assert "seal_embedded_tpu" not in forbidden_modules()
    finally:
        del sys.modules["seal_embedded_tpu_torch_probe"]

"""No JAX in a measured process: the guard compares whole top-level names,
and neither the harness nor the reference loads JAX or the JAX package;
the reference loads nothing of the port either."""

import subprocess
import sys
from pathlib import Path

from harness.device import forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def test_guard_compares_whole_top_level_names():
    names = ["canonicalvoting_tpu_torch", "canonicalvoting_tpu_torch.ops.hv_splat",
             "jaxtyping", "flaxen", "numpy", "torch"]
    assert forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "canonicalvoting_tpu", "canonicalvoting_tpu.ops.pallas"]
    assert forbidden_modules(names + bad) == sorted(bad)


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{str(HERE)!r}, "
         f"{str(HERE.parent)!r}]\n{code}\nprint(sorted({{m.split('.')[0] "
         f"for m in sys.modules}}))"], capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    top = _loaded("from reference import minkunet, tail, train")
    assert not top & {"jax", "jaxlib", "flax", "canonicalvoting_tpu",
                      "canonicalvoting_tpu_torch"}


def test_harness_and_drivers_load_no_jax():
    top = _loaded("import run\nfrom harness import manifest\n"
                  "from drivers import separate_eval, joint_train\n"
                  "import canonicalvoting_tpu_torch.eval.separate\n"
                  "import canonicalvoting_tpu_torch.train.steps")
    assert not top & {"jax", "jaxlib", "flax", "canonicalvoting_tpu"}


def test_a_checkout_of_only_the_benchmark_exits_without_a_result(tmp_path):
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "separate9-eval",
         "--seed", "1", "--seconds", "1", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

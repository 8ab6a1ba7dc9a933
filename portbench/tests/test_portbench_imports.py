"""Nothing the benchmark runs on the card loads JAX or the JAX package,
compared by whole top-level names (``ray_tpu_torch`` is not ``ray_tpu``),
and the reference loads nothing of the program."""

import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(harness.ROOT)
CARD_MODULES = ["portbench.harness", "portbench.drivers.serve",
                "portbench.drivers.train", "portbench.trace",
                "portbench.readers", "portbench.reference.model",
                "portbench.reference.train", "portbench.calibrate",
                "portbench.sweep", "ray_tpu_torch.llm.serving",
                "ray_tpu_torch.models.train_step", "ray_tpu_torch.ops._build",
                "torch.profiler"]


def loaded_after(modules):
    code = ("import importlib, sys, json\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "from portbench import harness\n"
            "import glob, os\n"
            "for p in sorted(glob.glob(os.path.join(str(harness.HERE), "
            "'metrics', '*.py'))):\n"
            "    harness.reader(os.path.basename(p)[:-3])\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_card_modules_load_no_jax():
    tops = loaded_after(CARD_MODULES)
    assert "ray_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after(["portbench.reference.model",
                         "portbench.reference.train"])
    assert not tops & {"ray_tpu_torch", "ray_tpu", "jax"}, tops


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    mods = {"ray_tpu_torch": sys, "ray_tpu_torch.llm": sys, "jaxtyping": sys,
            "flaxen.x": sys, "torch": sys}
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == []
    mods["jax.numpy"] = sys
    mods["ray_tpu._private"] = sys
    assert harness.forbidden_modules() == ["jax", "ray_tpu"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "mistral7b-chat", "--seed", str(2 ** 31 + 3), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert out.stdout.strip() == ""

"""Import hygiene of the port: gslora_tpu_torch and chip_smoke.py use
neither JAX nor the JAX package. The import check runs in a subprocess,
because this test process has JAX loaded already (tests/conftest.py)."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gslora_tpu_torch"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import gslora_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gslora_tpu_torch.__path__,
                                               "gslora_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "gslora_tpu"))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 25  # every module of the package was imported
    assert bad.strip() == "[]", bad


def test_no_source_names_jax_or_the_jax_package():
    forbidden = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|gslora_tpu)\b"
        r"|\bgslora_tpu\.", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if forbidden.search(f.read_text())]
    assert offenders == []


def test_native_io_and_parallel_are_the_ports_own():
    """The port builds its native libraries from its own csrc/*.cpp and
    never loads the JAX package's library; the parallel modules (the mesh,
    the feeding, the pipeline, the sharding) are imported by the walk
    above."""
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.replace(
            "print(len(names), bad)",
            "print(sorted(n for n in names if '.native' in n or "
            "'.parallel' in n))")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted([
        "gslora_tpu_torch.native", "gslora_tpu_torch.parallel",
        "gslora_tpu_torch.parallel.mesh",
        "gslora_tpu_torch.parallel.multihost",
        "gslora_tpu_torch.parallel.pipeline",
        "gslora_tpu_torch.parallel.sharding"]))
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cpp")) == \
        ["imagedec.cpp", "recordio.cpp"]
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cpp")) + \
        [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if re.search(r"libgslora_native|native/Makefile|"
                              r"gslora_tpu/native/\w", f.read_text())]
    assert offenders == []


def test_shell_mirrors_run_the_port():
    """Every script mirror under gslora_tpu_torch/scripts calls the port's
    CLIs and never the JAX package's."""
    scripts = sorted((PORT / "scripts").glob("*.sh"))
    assert len(scripts) == 7
    jax_package = re.compile(r"\bgslora_tpu\.")
    for path in scripts:
        text = path.read_text()
        assert "python -m gslora_tpu_torch.cli." in text, path.name
        assert not jax_package.search(text), path.name


def test_dcp_io_is_the_ports_own():
    """checkpoints/dcp_io.py (the counterpart of the JAX package's
    orbax_io) is walked by the import check, imports neither JAX, orbax
    nor the JAX package when imported alone, and names none of them."""
    code = IMPORT_ALL.replace(
        "print(len(names), bad)",
        "print('gslora_tpu_torch.checkpoints.dcp_io' in names)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
    alone = subprocess.run(
        [sys.executable, "-c",
         "import sys, gslora_tpu_torch.checkpoints.dcp_io as m\n"
         "m.AsyncSaver, m.save_dcp, m.load_dcp\n"
         "print(sorted(n for n in sys.modules if n.split('.')[0] in "
         "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gslora_tpu')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert alone.returncode == 0, alone.stderr
    assert alone.stdout.strip() == "[]"
    source = (PORT / "checkpoints" / "dcp_io.py").read_text()
    assert "torch.distributed.checkpoint" in source
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"orbax|gslora_tpu)\b|\bgslora_tpu\.", source,
                         re.M)


def test_integration_tools_are_the_ports_own():
    """The flagship integration tools (tools/flagship and the ports of
    scripts/integration_*.py) are walked by the import check, import
    neither JAX nor the JAX package nor scripts/ when imported alone, and
    name none of them."""
    tools = ["flagship", "integration_synthetic", "integration_baselines",
             "integration_baselines_cl", "integration_continual"]
    code = IMPORT_ALL.replace(
        "print(len(names), bad)",
        "print(sorted(n for n in names if '.tools.' in n))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = {n.rsplit(".", 1)[1] for n in ast.literal_eval(out.stdout)}
    assert set(tools) <= walked, sorted(walked)
    alone = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         + "".join(f"import gslora_tpu_torch.tools.{t}\n" for t in tools)
         + "print(sorted(n for n in sys.modules if n.split('.')[0] in "
           "('jax', 'jaxlib', 'flax', 'optax', 'gslora_tpu', 'scripts')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert alone.returncode == 0, alone.stderr
    assert alone.stdout.strip() == "[]"
    for t in tools:
        source = (PORT / "tools" / f"{t}.py").read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                             r"gslora_tpu|scripts)\b|\bgslora_tpu\.|"
                             r"\bscripts\.\w", source, re.M), t

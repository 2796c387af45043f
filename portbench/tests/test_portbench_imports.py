"""Nothing the benchmark runs loads JAX or the JAX package (tpusfm); the check
compares whole top-level module names, since tpusfm_torch begins with tpusfm."""
import subprocess
import sys

from portbench.run import ROOT, forbidden_modules


def test_names_compare_whole():
    assert forbidden_modules(["tpusfm_torch", "tpusfm_torch.pipeline", "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["tpusfm", "tpusfm.pipeline"]) == ["tpusfm"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen", "torch"]) == [
        "flax", "jax", "jaxlib"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys, glob, os\n"
        "from portbench import run, check, trace, render, roofline, readings\n"
        "from portbench.reference import detect, match, geometry\n"
        "import tpusfm_torch.pipeline, tpusfm_torch.pipeline.engine\n"
        "import tpusfm_torch.pipeline.collection, tpusfm_torch.features.pallas_match\n"
        "for kind in ('jobs', 'scenes', 'metrics'):\n"
        "    for p in glob.glob(os.path.join(run.HERE, kind, '*.py')):\n"
        "        n = os.path.basename(p)[:-3]\n"
        "        if n != '__init__':\n"
        "            run.load_module(kind, n)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"

"""The port stands alone: it imports torch and numpy, never JAX and never
gpuseqalign_tpu; and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpuseqalign_tpu_torch
from gpuseqalign_tpu_torch.bench import (
    autotune,
    fuzz,
    giant_demo,
    headline,
    vpu_probe,
)
from gpuseqalign_tpu_torch.bench.cli import main
from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    make_alg_input,
)
from gpuseqalign_tpu_torch.utils.device import resolve_device

PKG_DIR = os.path.dirname(gpuseqalign_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
RESRC = os.path.join(REPO, "resrc")
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), PKG_DIR)
    for d, _, files in os.walk(PKG_DIR) for f in files if f.endswith(".py")
)


def _foreign(name):
    return name in ("jax", "gpuseqalign_tpu") or name.startswith(
        ("jax.", "jaxlib", "gpuseqalign_tpu.")
    )


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax(path):
    with open(os.path.join(PKG_DIR, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _foreign(n)]


def test_importing_every_module_loads_no_jax():
    code = """
import json, pkgutil, importlib, sys
import gpuseqalign_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
print(json.dumps({"mods": mods, "loaded": sorted(sys.modules)}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("ops.mlsp_cuda", "bench.cli", "parallel.batch",
                "ops.batch_cuda", "bench.throughput", "ops.dense_cuda",
                "ops.dense_kernels", "ops.banded_plain", "ops.banded_cuda",
                "parallel.mesh", "parallel.giant2", "parallel.giant",
                "parallel.multihost", "ops.probe_plain", "ops.probe_cuda",
                "bench.vpu_probe", "bench.headline", "ops.wavefront",
                "ops.wavefront_cuda", "ops.wavefront_plain",
                "ops.strip_cuda", "ops.tiny_cuda", "ops.tuned",
                "bench.fuzz", "bench.autotune", "bench.giant_demo"):
        assert f"gpuseqalign_tpu_torch.{mod}" in got["mods"]
    assert [m for m in got["loaded"] if _foreign(m)] == []


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", ["cli", "vpu_probe", "headline", "fuzz",
                                   "autotune", "giant_demo"])
def test_main_without_device_raises_without_cuda(tmp_path, no_cuda, entry):
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"cpu1_st_row": {}}))
    argv = {
        "cli": [
            "--substPath", os.path.join(RESRC, "subst.json"),
            "--algParamPath", str(params),
            "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
            "--resPath", str(tmp_path / "out.tsv"),
        ],
        "vpu_probe": ["all"],
        "headline": ["--n", "300", "--oracleN", "64"],
        "fuzz": ["--cases", "1", "--seconds", "0"],
        "autotune": [
            "--algParamPath", str(params),
            "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
            "--substPath", os.path.join(RESRC, "subst.json"),
            "--pair", "len31", "len33",
        ],
        "giant_demo": ["300", "nw_ag"],
    }[entry]
    entry_main = {"cli": main, "vpu_probe": vpu_probe.main,
                  "headline": headline.main, "fuzz": fuzz.main,
                  "autotune": autotune.main,
                  "giant_demo": giant_demo.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_main(argv)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_resolve_device_raises_without_cuda(no_cuda, device):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(device)


def test_align_defaults_to_the_card(blosum62, no_cuda):
    y = np.zeros(11, np.int32)
    nw = make_alg_input(blosum62, y, y, -11, 0, "nw_lg")
    assert nw.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        get_algorithm_map()["tpu7_pallas_mlsp"].align(
            AlgParams({}), nw, AlgResult()
        )

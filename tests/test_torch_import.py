"""spann3r_torch imports without JAX, contains no library attention or
compilation calls, and its kernel wrappers dispatch by device: the plain
version on the CPU (launch counts untouched), the CUDA kernel on a card,
and nothing else anywhere."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spann3r_torch.ops import _kernels
from spann3r_torch.ops import attention, memory_read, rope

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "spann3r_torch"

MODULES = [
    "spann3r_torch", "spann3r_torch.config", "spann3r_torch.api",
    "spann3r_torch.ops.layers", "spann3r_torch.ops._kernels",
    "spann3r_torch.ops.rope", "spann3r_torch.ops.attention",
    "spann3r_torch.ops.memory_read", "spann3r_torch.models.vit",
    "spann3r_torch.models.heads", "spann3r_torch.models.dust3r",
    "spann3r_torch.models.memory", "spann3r_torch.models.spann3r",
    "spann3r_torch.utils.convert", "spann3r_torch.models.pairs",
    "spann3r_torch.models.inference", "spann3r_torch.models.offline",
    "spann3r_torch.ops.quant", "spann3r_torch.utils.masked",
    "spann3r_torch.utils.geometry", "spann3r_torch.losses",
    "spann3r_torch.tools.eval_pipeline", "spann3r_torch.utils.image",
    "spann3r_torch.utils.export", "spann3r_torch.utils.pnp",
    "spann3r_torch.native", "spann3r_torch.tools.icp",
    "spann3r_torch.tools.eval_recon", "spann3r_torch.tools.vis",
    "spann3r_torch.habitat_gen", "spann3r_torch.habitat_gen.quat",
    "spann3r_torch.habitat_gen.geometry", "spann3r_torch.habitat_gen.backends",
    "spann3r_torch.datasets", "spann3r_torch.datasets.cropping",
    "spann3r_torch.datasets.base", "spann3r_torch.datasets.loader",
    "spann3r_torch.datasets.demo", "spann3r_torch.datasets.seven_scenes",
    "spann3r_torch.datasets.nrgbd", "spann3r_torch.datasets.dtu",
    "spann3r_torch.datasets.synth", "spann3r_torch.demo", "spann3r_torch.eval",
    "spann3r_torch.bench", "spann3r_torch.app", "spann3r_torch.ops",
    "spann3r_torch.models", "spann3r_torch.utils", "spann3r_torch.tools",
    "spann3r_torch.training", "spann3r_torch.train",
    "spann3r_torch.utils.metrics", "spann3r_torch.datasets.sampler",
    "spann3r_torch.tools.convergence", "spann3r_torch.tools.convergence_gate",
    "spann3r_torch.tools.int8_gate", "spann3r_torch.tools.bf16fast_gate",
    "spann3r_torch.tools.readiness_drill", "spann3r_torch.tools.train_memory",
    "spann3r_torch.parallel", "spann3r_torch.parallel.mesh",
    "spann3r_torch.parallel.sharding",
    "spann3r_torch.datasets.scannet", "spann3r_torch.datasets.scannetpp",
    "spann3r_torch.datasets.arkit", "spann3r_torch.datasets.blendedmvs",
    "spann3r_torch.datasets.co3d", "spann3r_torch.datasets.habitat",
    "spann3r_torch.datasets.pairs", "spann3r_torch.habitat_gen.generator",
    "spann3r_torch.habitat_gen.scripts", "spann3r_torch.tools.extract_crops",
    "spann3r_torch.tools.dataset_fixtures", "spann3r_torch.tools.croco_demo",
    "spann3r_torch.models.croco_pretrain", "spann3r_torch.pretraining",
    "spann3r_torch.pretrain", "spann3r_torch.tools.pretrain_profile",
    "spann3r_torch.models.global_align", "spann3r_torch.utils.viz3d",
    "spann3r_torch.utils.trace", "spann3r_torch.utils.graphs",
    "spann3r_torch.parallel.streams", "spann3r_torch.tools.render_dtu",
    "spann3r_torch.tools.serving_table",
    "spann3r_torch.models.croco_downstream", "spann3r_torch.stereoflow",
    "spann3r_torch.stereoflow.io", "spann3r_torch.stereoflow.augmentor",
    "spann3r_torch.stereoflow.datasets", "spann3r_torch.stereoflow.criterion",
    "spann3r_torch.stereoflow.head", "spann3r_torch.stereoflow.tiling",
    "spann3r_torch.stereoflow.engine", "spann3r_torch.stereoflow.driver",
    "spann3r_torch.stereoflow_train", "spann3r_torch.stereoflow_test",
    "spann3r_torch.tools.stereoflow_fixtures",
    "spann3r_torch.tools.stereoflow_profile",
]


def test_every_module_is_listed():
    """Each module of the package is in MODULES, so the JAX check covers
    it."""
    found = {".".join(p.relative_to(REPO).with_suffix("").parts)
             .removesuffix(".__init__") for p in PKG.rglob("*.py")}
    assert found == set(MODULES)


def test_imports_leave_jax_out():
    # only modules these imports add count (a site hook may preload others)
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in set(sys.modules) - before\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'spann3r_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("needle", [
    "scaled_dot_product_attention", "torch.compile", "import jax",
    "from jax", "import spann3r_tpu", "from spann3r_tpu", "cublas", "cudnn"])
def test_no_library_kernels_or_jax(needle):
    # the port's TF32 policy (config.set_tf32_policy) sets one flag of the
    # convolution library, and calls nothing of it
    flag = "torch.backends.cudnn.allow_tf32"
    hits = [str(p.relative_to(REPO)) for p in PKG.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh")
            and needle in p.read_text().replace(flag, "").lower()]
    assert not hits, hits


def test_cpu_wrappers_take_the_plain_version():
    _kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 64, generator=g)
    pos = torch.randint(0, 4, (1, 8, 2), generator=g)
    torch.testing.assert_close(rope.rope_2d(q, pos), rope.rope_2d_plain(q, pos))
    torch.testing.assert_close(attention.sdpa(q, q, q, 0.125),
                               attention.sdpa_plain(q, q, q, 0.125))
    x = torch.randn(1, 8, 16, generator=g)
    bank = torch.randn(1, 32, 16, generator=g)
    size = torch.tensor([20], dtype=torch.int32)
    out, asum = memory_read.memory_read_attention(x, bank, bank, size, 5e-4)
    ref = memory_read.memory_read_attention_plain(x, bank, bank, size, 5e-4)
    torch.testing.assert_close(out, ref[0])
    torch.testing.assert_close(asum, ref[1])
    assert _kernels.launch_counts() == {"rope2d": 0, "sdpa": 0,
                                        "memory_read": 0, "sdpa_bwd": 0,
                                        "rope2d_bwd": 0}


def test_other_devices_raise():
    """No silent path: a tensor neither on the CPU nor on CUDA raises."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    pos = torch.empty(1, 8, 2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        rope.rope_2d(q, pos)
    with pytest.raises(NotImplementedError):
        attention.sdpa(q, q, q, 0.125)
    with pytest.raises(NotImplementedError):
        memory_read.memory_read_attention(q[0], q[0], q[0], pos[0, 0, :1], 5e-4)


def test_kernel_build_is_keyed_by_sources():
    """The library name hashes the sources and flags, inside the package's
    build directory (listed in .gitignore)."""
    path = _kernels.library_path()
    assert path.parent == PKG / "_build"
    assert path.name.startswith("libspann3r_kernels_") and path.suffix == ".so"
    assert {p.name for p in _kernels._sources()} >= {
        "rope2d.cu", "sdpa.cu", "sdpa_bwd.cu", "memory_read.cu", "common.cuh"}
    assert "spann3r_torch/_build/" in (REPO / ".gitignore").read_text()


# A stand-in for nvcc: writes its arguments to the file after -o; with -c
# it fails for sources whose name contains $FAKE_NVCC_FAIL.
_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
case " $* " in
  *" -c "*) if [ -n "$FAKE_NVCC_FAIL" ]; then
              case "$*" in *"$FAKE_NVCC_FAIL"*) echo "bad source"; exit 1;; esac
            fi;;
esac
echo "$@" > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    (bindir / "nvcc").write_text(_FAKE_NVCC)
    (bindir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_kernel_build_compiles_each_source_then_links(fake_nvcc):
    so = _kernels.build()
    assert so == _kernels.library_path() and so.parent == fake_nvcc
    link = so.read_text().split()
    assert "-shared" in link and "-c" not in link
    objs = [a for a in link if a.endswith(".o")]
    sources = [s.stem for s in _kernels._sources() if s.suffix == ".cu"]
    assert sorted(Path(o).name.split(".")[-2] for o in objs) == sorted(sources)
    assert not list(fake_nvcc.glob("*.o"))   # objects removed after the link
    assert _kernels.build() == so            # built once per source hash


def test_kernel_build_failure_names_the_source(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "memory_read.cu")
    with pytest.raises(RuntimeError, match="memory_read.cu"):
        _kernels.build()
    assert not _kernels.library_path().exists()
    assert not list(fake_nvcc.glob("*.o")) and not list(fake_nvcc.glob("*.tmp"))

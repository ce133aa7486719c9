"""The port's boundaries: it imports nothing of jax or of the JAX package
(``phylign_tpu``), eagerly or lazily, it picks the plain PyTorch
version only for CPU tensors, it never moves to the CPU on its own, kernel
failures are not retried, every kernel source is built and bound, and a
multi-process run whose process group does not form exits non-zero."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import phylign_tpu_torch
from phylign_tpu_torch import cli
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.ops import _kernels
from phylign_tpu_torch.ops import match as opm
from phylign_tpu_torch.pipeline import stages
from phylign_tpu_torch.utils.platform import resolve_device

REPO = Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "phylign_tpu"))


PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "phylign_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
)


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_source_imports_nothing_of_jax_or_the_jax_package(rel):
    """A static scan of every import statement, at top level and inside
    functions (a lazy import runs only when its function does), plus
    importlib calls spelled with a literal name."""
    tree = ast.parse((REPO / rel).read_text(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and _forbidden(str(node.args[0].value))
        ):
            bad.append(node.args[0].value)
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_lazy_imports():
    """The scan's own check: a lazy import of the JAX package inside a
    function is found."""
    src = "def f():\n    from phylign_tpu.kmer import encode_seq\n    import jax.numpy\n"
    found = [
        n for n in ast.walk(ast.parse(src))
        if isinstance(n, (ast.Import, ast.ImportFrom))
        and _forbidden(getattr(n, "module", None) or n.names[0].name)
    ]
    assert len(found) == 2
    assert not _forbidden("phylign_tpu_torch.kmer")


def test_no_module_imports_jax():
    """Every module of the package, imported in a fresh interpreter,
    leaves jax and the JAX package (phylign_tpu, phylign_tpu.*) out of
    sys.modules. The walk reaches every subpackage (a directory without an
    __init__.py would be skipped): align.fused and parallel's modules
    among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import phylign_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 10, mods\n"
        "need = {'phylign_tpu_torch.align.fused', 'phylign_tpu_torch.align.engine',\n"
        "        'phylign_tpu_torch.parallel.mesh', 'phylign_tpu_torch.parallel.dist',\n"
        "        'phylign_tpu_torch.parallel.launch'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'phylign_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, (9, 2)).astype(np.int32))
    words[-1] = 0
    rows = torch.from_numpy(rng.integers(0, 9, (3, 64)).astype(np.int32))
    assert torch.equal(opm.match_scores(words, rows), opm.match_scores_ref(words, rows))


@pytest.mark.parametrize("fn", [opm.match_scores_b1, opm.match_scores_b2])
def test_kernels_refuse_cpu_tensors(fn):
    words = torch.zeros((9, 2), dtype=torch.int32)
    rows = torch.zeros((3, 64), dtype=torch.int32)
    before = opm.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fn(words, rows)
    assert opm.launch_counts() == before


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_launch_counts_reset():
    opm.reset_launch_counts()
    assert set(opm.launch_counts()) == {
        "match_popcount_b1", "match_popcount_b2", "match_popcount_acc", "match_popcount_keep"
    }
    assert not any(opm.launch_counts().values())


def test_kernel_error_is_not_retried(tmp_path, monkeypatch):
    """A kernel build/launch failure in the pipelined path propagates; the
    job path (which runs the same kernels) is not tried."""
    pl = stages.Pipeline(Config(batches="b.txt"), tmp_path, device="cpu")

    def boom(stem, batches):
        raise _kernels.KernelError("launch failed")

    job_calls = []
    monkeypatch.setattr(pl, "_match_pipelined", boom)
    monkeypatch.setattr(pl, "match_one_batch", lambda b, s: job_calls.append(b))
    with pytest.raises(_kernels.KernelError):
        pl.match("stem", ["b1"])
    assert job_calls == []


def test_other_errors_fall_back_to_the_job_path(tmp_path, monkeypatch):
    pl = stages.Pipeline(Config(batches="b.txt"), tmp_path, device="cpu")

    def boom(stem, batches):
        raise RuntimeError("transient")

    monkeypatch.setattr(pl, "_match_pipelined", boom)
    monkeypatch.setattr(pl, "match_one_batch", lambda b, s: f"{b}:{s}")
    assert pl.match("stem", ["b1", "b2"]) == ["b1:stem", "b2:stem"]


def test_mesh_is_not_ported(tmp_path):
    """A mesh is ported: a CPU pipeline builds its mesh_shape lazily, every
    shard on the CPU; a mesh that its devices cannot fill is refused."""
    pl = stages.Pipeline(Config(mesh_shape="2x1"), tmp_path, device="cpu")
    assert pl.mesh().shape == {"d": 2, "q": 1}
    assert pl.mesh() is pl.mesh()
    assert stages.Pipeline(Config(), tmp_path, device="cpu").mesh() is None
    bad = stages.Pipeline(Config(mesh_shape="2x2"), tmp_path, device="cpu", mesh_devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="devices"):
        bad.mesh()


@pytest.mark.parametrize("cmd", ["map", "all"])
def test_unported_commands_exit_nonzero(cmd):
    """--distributed whose process group cannot form (a rank outside the
    world) exits non-zero, naming the group, before any work."""
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--device", "cpu", "--distributed", "--num-processes", "2", "--process-id", "5"])
    assert "process group did not form" in str(e.value.code)
    assert "rank of 2" in str(e.value.code)


KERNEL_ENTRIES = {
    "match_popcount": ("phylign_match_popcount_b1", "phylign_match_popcount_b2",
                       "phylign_match_popcount_acc", "phylign_match_popcount_keep"),
    "chain_scan": ("phylign_chain_scan",),
    "extend_scan": ("phylign_extend_scan",),
    "traceback_walk": ("phylign_traceback_walk",),
    "ref_index": ("phylign_ref_sketch", "phylign_ref_sort"),
    "flush_epilogue": ("phylign_chain_select", "phylign_select_window", "phylign_finish_pack",
                       "phylign_compact_cold"),
    "match_epilogue": ("phylign_hash_rows", "phylign_threshold_topk", "phylign_pack_hits",
                       "phylign_merge_topk"),
}
#: exported sizes a wrapper asks for before its launch (int64_t results)
KERNEL_QUERIES = {"flush_epilogue": ("phylign_chain_select_workspace",),
                  "match_epilogue": ("phylign_threshold_topk_workspace",),
                  "ref_index": ("phylign_ref_sort_hist_len",)}


@pytest.mark.parametrize("name", sorted(KERNEL_ENTRIES))
def test_every_kernel_source_is_built_and_bound(name):
    """Each csrc/*.cu builds into build/phylign_tpu_torch under a name
    keyed by its source, and _bind declares every C entry it exports (a
    pointer or stream passed without c_void_p would be cut to 32 bits)."""
    import ctypes
    import types

    assert sorted(p.stem for p in _kernels.SRC_DIR.glob("*.cu")) == sorted(KERNEL_ENTRIES)
    p = _kernels._lib_path(name)
    assert p.parent == REPO / "build" / "phylign_tpu_torch"
    assert p.name.startswith(f"lib{name}_") and p.suffix == ".so"
    src = (_kernels.SRC_DIR / f"{name}.cu").read_text()
    queries = KERNEL_QUERIES.get(name, ())
    fake = types.SimpleNamespace(**{
        fn: types.SimpleNamespace() for fn in (*KERNEL_ENTRIES[name], *queries, "phylign_cuda_error_string")
    })
    _kernels._bind(name, fake)
    for fn in queries:
        assert f"int64_t {fn}(" in src and getattr(fake, fn).restype is ctypes.c_int64
    for fn in KERNEL_ENTRIES[name]:
        assert f"int {fn}(" in src
        entry = getattr(fake, fn)
        assert entry.restype is ctypes.c_int
        assert ctypes.c_void_p in entry.argtypes and entry.argtypes[-1] is ctypes.c_void_p
    assert "phylign_cuda_error_string" in src and "cudaGetLastError()" in src


def test_align_kernels_refuse_cpu_tensors():
    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope

    r = torch.zeros((2, 32), dtype=torch.int32)
    before = (opc.launch_counts(), ope.launch_counts())
    with pytest.raises(ValueError, match="CUDA"):
        opc.chain_dp_cuda(r, r, torch.zeros(101), 21, 100, 100)
    q = torch.zeros((2, 32), dtype=torch.uint8)
    w = torch.zeros((2, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ope.extend_cuda(q, torch.zeros(2, dtype=torch.int32), w, w)
    assert (opc.launch_counts(), ope.launch_counts()) == before
    assert set(opc.launch_counts()) == {"chain_scan", "chain_select"}
    assert set(ope.launch_counts()) == {"extend_scan"}


def test_align_entry_points_default_to_cuda():
    import inspect

    from phylign_tpu_torch.align import engine

    for fn in (engine.flush_pairs, engine.flush_pairs_fused, engine.flush_pairs_host,
               engine.flush_pairs_begin, engine.align_batch, engine.align_batches_pooled):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            engine.flush_pairs_fused([], engine.AlignParams())


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Nothing is built at import; the library's name carries a hash of
    the source and flags, under build/phylign_tpu_torch."""
    assert _kernels._libs == {} or not torch.cuda.is_available()
    p = _kernels._lib_path("match_popcount")
    assert p.parent == REPO / "build" / "phylign_tpu_torch"
    assert p.name.startswith("libmatch_popcount_") and p.suffix == ".so"
    assert (_kernels.SRC_DIR / "match_popcount.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert phylign_tpu_torch.__version__


def test_benchmark_log_survives_missing_io_counters(tmp_path, monkeypatch):
    """On hosts whose /proc/<pid>/io lacks ``rchar``, psutil's io_counters
    raises ValueError; the port's stage logger writes its row with zero
    FS columns instead of failing the stage."""
    import psutil

    from phylign_tpu_torch.utils import bench

    class NoIO:
        def io_counters(self):
            raise ValueError("b'rchar' field was not found in /proc/1/io")

    monkeypatch.setattr(psutil, "Process", NoIO)
    with bench.benchmark(tmp_path, "run_cobs", "b____s"):
        pass
    lines = (tmp_path / "benchmarks" / "run_cobs" / "b____s.txt").read_text().splitlines()
    assert lines[0] == bench.HEADER
    assert lines[1].split("\t")[5:7] == ["0", "0"]

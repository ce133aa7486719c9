"""The port's multi-process path (``torch.distributed`` with ``gloo`` on
loopback, two processes on the CPU), in the style of
tests/test_distributed.py: a 2x2 mesh whose doc axis crosses the boundary
between the two processes runs the full Matcher.score_hits path (sharded
scoring, threshold, the top-k gather over "d" as an
all_gather_into_tensor) and must return exactly what one process without
a mesh returns, and what the JAX package returns. Also the scheduler
environment detection against the JAX function, and a two-rank
``cli all --distributed`` run against the one-process run.

The worker is this file run as a script; it imports no jax (it checks).

    python tests/test_torch_distributed.py worker <pid> <num> <port> <outdir>
"""

import gzip
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(REPO)
    return env


def _join(procs, timeout: float = 240) -> list[str]:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = [q.communicate()[0][-2000:] for q in procs]
            raise AssertionError(f"timed out after {timeout} s:\n" + "\n----\n".join(tails)) from None
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-4000:]}"
    return outs


def build_index(cobs):
    """tests/distributed_worker.py:build_index with either package's cobs
    module: 40 docs of 400 bp, 8 planted queries and one unplanted."""
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)
    docs, seqs = [], []
    for d in range(40):
        s = bytes(rng.choice(bases, 400))
        docs.append((f"{d:04d}_ACC{d:05d}", [s]))
        if d % 5 == 0:
            seqs.append(s[37 : 37 + 150])
    seqs.append(bytes(rng.choice(bases, 150)))
    idx = cobs.build_classic_index(docs, term_size=31, fpr=0.05)
    return cobs.to_device_index(idx), seqs


def _rows(matcher, seqs):
    """Each query's Bloom rows (the dense score_rows path, which fetches a
    Sharded score matrix across processes)."""
    from phylign_tpu_torch.kmer import cobs_row_indices, encode_seq

    return [
        cobs_row_indices(encode_seq(s), matcher.term_size, matcher.signature_size, matcher.num_hashes)
        for s in seqs
    ]


def worker(pid: int, num: int, port: int, outdir: str) -> None:
    import torch.distributed as dist

    from phylign_tpu_torch.io import cobs
    from phylign_tpu_torch.models.matcher import Matcher
    from phylign_tpu_torch.parallel.launch import init_distributed
    from phylign_tpu_torch.parallel.mesh import make_mesh

    assert init_distributed("127.0.0.1", num, pid, port=port, device="cpu", timeout_s=120) == (num, pid)
    didx, seqs = build_index(cobs)
    mesh = make_mesh(2, 2, devices="cpu", group=dist.group.WORLD)
    assert (mesh.world, mesh.rank, mesh.n_local) == (num, pid, 2)
    assert [c[0] for c in mesh.local_cells()] == [pid, pid]  # doc axis across processes
    matcher = Matcher.from_device_index(didx, "cpu", mesh=mesh)
    hits, n_keep = matcher.score_hits(seqs, threshold=0.7, topn=3)
    scores, _, _ = matcher.score_rows(_rows(matcher, seqs[:3]), threshold=0.7)
    assert not any(m.split(".")[0] in ("jax", "phylign_tpu") for m in sys.modules)
    if pid == 0:
        with open(os.path.join(outdir, "result.json"), "w") as f:
            json.dump({"hits": hits, "n_keep": n_keep.tolist(), "scores": scores.tolist()}, f)
    dist.destroy_process_group()
    print(f"worker {pid} done", flush=True)


def test_two_process_mesh_equals_one_process_and_jax(tmp_path):
    from phylign_tpu.io import cobs as jcobs
    from phylign_tpu.models.matcher import Matcher as JaxMatcher
    from phylign_tpu_torch.io import cobs as tcobs
    from phylign_tpu_torch.models.matcher import Matcher

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "worker", str(pid), "2", str(port), str(tmp_path)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    _join(procs)
    got = json.loads((tmp_path / "result.json").read_text())
    got_hits = [sorted(tuple(h) for h in row) for row in got["hits"]]

    didx, seqs = build_index(tcobs)
    one = Matcher.from_device_index(didx, "cpu")
    want_hits, want_keep = one.score_hits(seqs, threshold=0.7, topn=3)
    jd, jseqs = build_index(jcobs)
    assert jseqs == seqs
    jhits, jkeep = JaxMatcher.from_device_index(jd).score_hits(seqs, threshold=0.7, topn=3)
    assert got_hits == [sorted(row) for row in want_hits] == [sorted((int(a), int(b)) for a, b in r) for r in jhits]
    assert got["n_keep"] == want_keep.tolist() == [int(x) for x in jkeep]
    assert sum(len(r) for r in want_hits) >= 8
    want_scores, _, _ = one.score_rows(_rows(one, seqs[:3]), threshold=0.7)
    assert got["scores"] == want_scores.tolist()


ENVS = {
    "slurm": {"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_STEP_NODELIST": "node[01-04],x"},
    "slurm_nodelist": {"SLURM_NTASKS": "3", "SLURM_NODELIST": "hostA,hostB"},
    "lsf": {"LSB_DJOB_NUMPROC": "3", "LSB_HOSTS": "h1 h2 h3", "LSF_PM_TASKID": "5"},
    "lsf_jobpid": {"LSB_DJOB_NUMPROC": "2", "LS_JOBPID": "7"},
    "none": {},
}


def test_detect_process_env_equals_jax(monkeypatch):
    from phylign_tpu.parallel.launch import detect_process_env as jax_detect
    from phylign_tpu_torch.parallel.launch import detect_process_env

    keys = {k for env in ENVS.values() for k in env}
    seen = []
    for name, env in ENVS.items():
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert detect_process_env() == jax_detect(), name
        seen.append(detect_process_env())
    assert seen == [("node", 4, 2), ("hostA", 3, 0), ("h1", 3, 2), (None, 2, 1), (None, 1, 0)]


@pytest.mark.parametrize("threads,cobs_threads", [(8, 4), ("all", 4), (8, "auto"), ("all", "auto")])
def test_check_cluster_config_equals_jax(threads, cobs_threads):
    """A cluster run refuses auto-scaled thread knobs, with the JAX
    function's message."""
    from phylign_tpu.config import Config as JaxConfig
    from phylign_tpu.parallel.launch import check_cluster_config as jax_check
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.parallel.launch import check_cluster_config

    def outcome(check, cfg):
        try:
            check(cfg)
        except ValueError as e:
            return str(e)
        return None

    got = outcome(check_cluster_config, Config(threads=threads, cobs_threads=cobs_threads))
    want = outcome(jax_check, JaxConfig(threads=threads, cobs_threads=cobs_threads))
    assert got == want
    assert (got is None) == (threads == 8 and cobs_threads == 4)


def _summary(wd: Path) -> bytes:
    return gzip.open(next((wd / "output").glob("*.sam_summary.gz")), "rb").read()


def test_two_rank_cli_all_distributed_equals_one_process(tmp_path):
    """Two ranks of ``cli all --distributed`` (gloo on loopback) share a
    workdir: each matches and aligns its batches, rank 0 filters and
    aggregates; sam_summary equals the one-process run's."""
    from phylign_tpu_torch import testing

    one, two = tmp_path / "one", tmp_path / "two"
    for wd in (one, two):
        testing.make_fixture(wd, n_batches=3, seed=42)
    inputs = lambda wd: sorted(str(p) for p in (wd / "input").iterdir())  # noqa: E731
    port = _free_port()
    base = [sys.executable, "-m", "phylign_tpu_torch.cli", "all", "--device", "cpu"]
    procs = [
        subprocess.Popen(
            [*base, "--workdir", str(two), "--config", str(two / "config.yaml"),
             "--distributed", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid),
             "--peer-wait-timeout", "240", *inputs(two)],
            env=_env(), cwd=two, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    out0, out1 = _join(procs)
    assert "pipeline done" in out0 and "rank 0 aggregates" in out1
    _join([subprocess.Popen(
        [*base, "--workdir", str(one), "--config", str(one / "config.yaml"), *inputs(one)],
        env=_env(), cwd=one, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )])
    assert _summary(two) == _summary(one)
    assert b"\t150=" in _summary(one)


def _stage_files(wd: Path) -> dict:
    out = {}
    for d in ("intermediate/03_match", "intermediate/04_filter", "intermediate/05_map", "output"):
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def test_two_rank_cli_all_over_a_mesh_spanning_processes(tmp_path):
    """``mesh_shape: 2x2`` under ``cli all --distributed`` with two gloo
    ranks: the mesh spans the two processes (rank r holds doc row r, so
    every batch's top-k gather crosses the boundary), every rank scores
    every batch and rank 0 writes 03_match; each rank aligns its own
    batches over its 1x2 part. 03_match, 04_filter, 05_map, sam_summary
    and stats equal the one-process run without a mesh."""
    from phylign_tpu_torch import testing

    one, two = tmp_path / "one", tmp_path / "two"
    for wd in (one, two):
        testing.make_fixture(wd, n_batches=3, seed=42)
    with open(two / "config.yaml", "a") as f:
        f.write("mesh_shape: 2x2\n")
    inputs = lambda wd: sorted(str(p) for p in (wd / "input").iterdir())  # noqa: E731
    port = _free_port()
    base = [sys.executable, "-m", "phylign_tpu_torch.cli", "all", "--device", "cpu"]
    procs = [
        subprocess.Popen(
            [*base, "--workdir", str(two), "--config", str(two / "config.yaml"),
             "--distributed", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid),
             "--peer-wait-timeout", "240", *inputs(two)],
            env=_env(), cwd=two, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    out0, out1 = _join(procs)
    assert "pipeline done" in out0 and "rank 0 aggregates" in out1
    assert "mesh 2x2 over 2 processes: rank 0 holds cells [(0, 0), (0, 1)]" in out0
    assert "mesh 2x2 over 2 processes: rank 1 holds cells [(1, 0), (1, 1)]" in out1
    _join([subprocess.Popen(
        [*base, "--workdir", str(one), "--config", str(one / "config.yaml"), *inputs(one)],
        env=_env(), cwd=one, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )])
    got, want = _stage_files(two), _stage_files(one)
    assert got == want
    assert sum(k.startswith("intermediate/03_match/") for k in got) == 3


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])

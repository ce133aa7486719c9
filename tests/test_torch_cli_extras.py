"""The port's CLI subcommands beyond match/map/all against the JAX CLI's
(``phylign_tpu.cli.main``) on the same ``make_fixture`` tree.

Each side builds its tree through its own ``fixture`` subcommand (same
seed) under its own root and runs with relative paths from there, so stdout
must be equal byte for byte. ``test`` and ``preflight`` run the port with
``--device cpu``; gzip members carry their write time, so .gz files are
compared decompressed. Read-only subcommands that take a path (``report``,
``index-sizes``, ``build-index``) run both CLIs on the same files.
"""

import contextlib
import gzip
import io
import os
import shutil
from pathlib import Path

import pytest

from phylign_tpu.cli import main as jax_main
from phylign_tpu_torch import cli

STEM = "reads_1___reads_2___reads_3___reads_4"
MAINS = {"jax": (jax_main, []), "torch": (cli.main, ["--device", "cpu"])}
#: subcommands that run the pipeline take --device on the port
DEVICE_CMDS = ("test", "preflight")


@contextlib.contextmanager
def cwd(path: Path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run(side: str, argv: list[str]) -> tuple[str, object]:
    """(stdout, SystemExit code or None) of one side's CLI."""
    main, dev = MAINS[side]
    if side == "torch" and argv[0] in DEVICE_CMDS:
        argv = [*argv, *dev]
    buf = io.StringIO()
    code = None
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


def tree(wd: Path, dirs=("input", "data", "cobs", "asms", "intermediate/03_match",
                         "intermediate/04_filter", "intermediate/05_map", "output")) -> dict:
    out = {"config.yaml": (wd / "config.yaml").read_bytes()}
    for d in dirs:
        for p in sorted((wd / d).rglob("*")):
            if p.is_file():
                raw = p.read_bytes()
                out[str(p.relative_to(wd))] = gzip.decompress(raw) if p.suffix == ".gz" else raw
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Per side: its root (holding ``wd``), and the stdout of ``fixture``
    and of ``test`` (the fixture's golden run) there."""
    res = {}
    for side in MAINS:
        root = tmp_path_factory.mktemp(side)
        with cwd(root):
            fx = run(side, ["fixture", "--workdir", "wd", "--n-batches", "2", "--seed", "11"])
            te = run(side, ["test", "--workdir", "wd"])
        res[side] = dict(root=root, fixture=fx, test=te)
    return res


def test_fixture_and_test_equal_jax(sides):
    j, t = sides["jax"], sides["torch"]
    assert t["fixture"] == j["fixture"]
    assert t["fixture"][0].startswith("fixture written under wd:")
    assert t["test"] == j["test"] == (
        "test PASSED: sam_summary columns 1-3 match the fixture oracle\n", None
    )
    assert tree(t["root"] / "wd") == tree(j["root"] / "wd")


@pytest.mark.parametrize(
    "argv",
    [
        ["config", "--workdir", "wd", "--nb-best-hits", "7", "--threshold", "0.8"],
        ["config", "--workdir", "wd", "--batches", "data/other.txt"],
        ["check-cluster", "--workdir", "wd"],
        ["inspect-index", "wd/cobs/synthetic_a__01.cobs_classic.xz"],
        ["stats", f"wd/output/{STEM}.sam_summary.gz"],
        ["stats", f"wd/output/{STEM}.sam_summary.gz",
         "--queries", f"wd/intermediate/01_queries_merged/{STEM}.fa"],
        ["preflight", "--workdir", "wd"],
        ["preflight", "--workdir", "wd", "--batch", "synthetic_b__01"],
        ["download", "--workdir", "wd"],
        ["download", "--workdir", "wd", "--only", "asms"],
    ],
    ids=lambda a: "-".join(a[:1] + [x for x in a[1:] if x.startswith("--")]),
)
def test_subcommand_stdout_equals_jax(sides, argv):
    got = {}
    for side in MAINS:
        with cwd(sides[side]["root"]):
            got[side] = run(side, argv)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] or got["torch"][1]


def test_check_cluster_passes_and_fails_like_jax(sides, tmp_path):
    (tmp_path / "ok.yaml").write_text("threads: 4\ncobs_threads: 2\n")
    for name, want in (("ok.yaml", ("config OK for cluster run\n", None)),):
        assert run("torch", ["check-cluster", "--config", str(tmp_path / name)]) == want
        assert run("jax", ["check-cluster", "--config", str(tmp_path / name)]) == want
    out, code = run("torch", ["check-cluster", "--workdir", str(sides["torch"]["root"] / "wd")])
    assert out == "" and code.startswith("ERROR: config is not valid for a cluster run")


def test_inspect_index_fails_on_corrupt_magic(tmp_path):
    import lzma

    from phylign_tpu_torch.testing import make_fixture

    make_fixture(tmp_path, n_batches=1, seed=13)
    idx = next((tmp_path / "cobs").glob("*.xz"))
    raw = bytearray(lzma.decompress(idx.read_bytes()))
    raw[:8] = b"XXXXXXXX"
    idx.write_bytes(lzma.compress(bytes(raw)))
    got = {side: run(side, ["inspect-index", str(idx)]) for side in MAINS}
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 1 and '"ok": false' in got["torch"][0]
    out, code = run("torch", ["preflight", "--workdir", str(tmp_path)])
    assert "[FAIL] COBS header parse + payload size" in out
    assert code.startswith("preflight FAILED")


def test_report_html_equals_jax(sides, tmp_path):
    root = tmp_path
    shutil.copytree(sides["jax"]["root"] / "wd", root / "wd")
    html = {}
    for side in MAINS:
        with cwd(root):
            out, code = run(side, ["report", "--workdir", "wd"])
        assert (out, code) == ("report written: wd/report.html\n", None)
        html[side] = (root / "wd" / "report.html").read_bytes()
    assert html["torch"] == html["jax"]
    assert b"Output stats" in html["torch"] and b"Stage benchmarks" in html["torch"]


@pytest.mark.parametrize("xz_on_path", [True, False], ids=["xz", "lzma"])
def test_index_sizes_equal_jax(sides, tmp_path, monkeypatch, xz_on_path):
    if not xz_on_path:
        monkeypatch.setenv("PATH", str(tmp_path))  # no xz binary there
    has_xz = shutil.which("xz") is not None
    assert xz_on_path or not has_xz
    cobs_dir = sides["jax"]["root"] / "wd" / "cobs"
    tables = {}
    for side in MAINS:
        out = tmp_path / side / "sizes.txt"
        assert run(side, ["index-sizes", "--cobs-dir", str(cobs_dir), "--out", str(out)]) == (
            f"scanned 2 indexes -> {out}\n", None
        )
        tables[side] = out.read_text()
    assert tables["torch"] == tables["jax"]
    rows = [ln.split() for ln in tables["torch"].splitlines()]
    assert [r[0] for r in rows] == ["cobs/synthetic_a__01.cobs_classic.xz",
                                    "cobs/synthetic_b__01.cobs_classic.xz"]
    import lzma

    for name, size, mem in rows:
        assert int(size) == len(lzma.decompress((cobs_dir / name[5:]).read_bytes()))
        # both packages read the decoder memory from the robot totals row's
        # field 10, which xz 5 fills with "sizes in headers": 0 either way
        assert mem == "0"


def test_build_index_is_byte_identical(sides, tmp_path):
    tar = sides["jax"]["root"] / "wd" / "asms" / "synthetic_a__01.tar.xz"
    built = {}
    for side in MAINS:
        out = tmp_path / f"{side}.cobs_classic.xz"
        got, code = run(side, ["build-index", str(tar), str(out), "--fpr", "0.1"])
        assert code is None
        built[side] = (got.replace(str(out), "OUT"), out.read_bytes())
    assert built["torch"] == built["jax"]
    assert built["torch"][0].startswith("built OUT: 4 docs, k=31,")
    info = run("torch", ["inspect-index", str(tmp_path / "torch.cobs_classic.xz")])[0]
    assert '"ok": true' in info and '"doc_names_rid_prefixed": true' in info


def test_clean_equal_jax_and_keeps_build(sides, tmp_path):
    got = {}
    for side in MAINS:
        root = tmp_path / side
        shutil.copytree(sides[side]["root"] / "wd", root / "wd")
        (root / "wd" / "build").mkdir()
        with cwd(root):
            plain = run(side, ["clean", "--workdir", "wd"])
            assert (root / "wd" / "cobs").exists()
            full = run(side, ["clean", "--workdir", "wd", "--all"])
        got[side] = (plain, full, sorted(p.name for p in (root / "wd").iterdir()))
    assert got["torch"] == got["jax"]
    plain, full, left = got["torch"]
    assert plain[0] == "removed wd/intermediate\nremoved wd/output\nremoved wd/logs\n"
    assert full[0] == "removed wd/cobs\nremoved wd/asms\n"
    assert left == ["build", "config.yaml", "data", "input"]


def test_reference_golden_mode(sides, tmp_path):
    """``test --golden``: the port's run diffed against a golden
    sam_summary (here the JAX run's output); a wrong golden fails."""
    import lzma

    src = sides["jax"]["root"] / "wd"
    golden = src / "output" / f"{STEM}.sam_summary.gz"
    wd = tmp_path / "wd"
    shutil.copytree(src, wd, ignore=shutil.ignore_patterns("intermediate", "output", "logs"))
    inputs = sorted(str(p) for p in (wd / "input").iterdir())
    batches = str(wd / "data" / "batches_small.txt")
    argv = ["test", "--workdir", str(wd), "--batches", batches]
    assert run("torch", [*argv, "--golden", str(golden), *inputs]) == (
        "test PASSED: sam_summary columns 1-3 match the reference golden file\n", None
    )
    bad = tmp_path / "bad.sam_summary.xz"
    with lzma.open(bad, "wt") as f:
        f.write("zz\t0\tnope\n")
    shutil.rmtree(wd / "intermediate")
    shutil.rmtree(wd / "output")
    assert run("torch", [*argv, "--golden", str(bad), *inputs]) == (
        "", "test FAILED: sam_summary differs from the reference golden file"
    )


def test_cli_entry_exit_codes(monkeypatch, capsys, tmp_path):
    """0 on success, 1 with the message (or traceback) on stderr, 130 on an
    interrupt; ``cuda`` on a host without a card fails, never runs on the CPU."""
    def code_of(argv):
        with pytest.raises(SystemExit) as ei:
            cli.cli_entry(argv)
        return ei.value.code

    assert code_of(["config", "--config", str(tmp_path / "none.yaml")]) == 0
    assert code_of(["check-cluster", "--config", str(tmp_path / "none.yaml")]) == 1
    assert "ERROR: config is not valid" in capsys.readouterr().err
    if not __import__("torch").cuda.is_available():
        assert code_of(["test", "--workdir", str(tmp_path / "t")]) == 1
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err

    def interrupted(argv):
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "main", interrupted)
    assert code_of([]) == 130

"""The port's ``pipeline/download`` against the JAX package's, served from a
loopback ``http.server`` (no test reaches the network): the same URL
routing, integrity checks, retry with linear backoff, thread-pool fetches
and statuses, and the ``download`` subcommand's stdout.
"""

import contextlib
import http.server
import io
import lzma
import os
import threading

import pytest

from phylign_tpu.cli import main as jax_main
from phylign_tpu.pipeline import download as jdl
from phylign_tpu_torch import cli
from phylign_tpu_torch.pipeline import download as tdl

MODS = {"jax": jdl, "torch": tdl}
#: incompressible, so the .xz stays above the 100 kB integrity floor
PAYLOAD = lzma.compress(os.urandom(200_000))


@pytest.fixture()
def server():
    """Serves PAYLOAD for every path; ``fail`` holds how many of the next
    requests answer 500. Yields (base url, request log, fail)."""
    hits, fail = [], [0]

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            if fail[0] > 0:
                fail[0] -= 1
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(PAYLOAD)))
            self.end_headers()
            self.wfile.write(PAYLOAD)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", hits, fail
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def _route(monkeypatch, mod, base: str) -> None:
    monkeypatch.setattr(mod, "cobs_url", lambda b: f"{base}/cobs/{b}.cobs_classic.xz")
    monkeypatch.setattr(mod, "asms_url", lambda b: f"{base}/asms/{b}.tar.xz")


@pytest.mark.parametrize("batch", ["aaa__01", "escherichia_coli__01", "eubacterium__01",
                                   "eubacterium", "zzz__01", "dustbin__01"])
def test_zenodo_routing_equals_jax(batch):
    assert tdl.cobs_url(batch) == jdl.cobs_url(batch)
    assert tdl.asms_url(batch) == jdl.asms_url(batch)


def test_download_batches_parallel_then_nothing(server, tmp_path, monkeypatch):
    base, hits, _ = server
    batches = [f"b{i:02d}__01" for i in range(5)]
    status = {}
    for side, mod in MODS.items():
        _route(monkeypatch, mod, base)
        status[side] = mod.download_batches(
            batches, tmp_path / side, retries=0, retry_wait=0, max_threads=4
        )
    assert status["torch"] == status["jax"]
    assert set(status["torch"].values()) == {"downloaded (cobs+asms)"}
    assert len(hits) == 20
    for b in batches:
        assert (tmp_path / "torch" / "cobs" / f"{b}.cobs_classic.xz").read_bytes() == PAYLOAD
        assert (tmp_path / "torch" / "asms" / f"{b}.tar.xz").read_bytes() == PAYLOAD
    again = tdl.download_batches(batches, tmp_path / "torch", retries=0, retry_wait=0)
    assert set(again.values()) == {"already present"}
    assert len(hits) == 20  # no request for present files
    assert not list((tmp_path / "torch").rglob("*.part"))


def test_failed_url_raises_like_jax(tmp_path, monkeypatch):
    errs = {}
    for side, mod in MODS.items():
        monkeypatch.setattr(mod, "cobs_url", lambda b: "http://127.0.0.1:1/none.xz")
        with pytest.raises(RuntimeError, match="download") as ei:
            mod.download_batches(["x__01"], tmp_path / side, retries=0, retry_wait=0, only="cobs")
        errs[side] = str(ei.value)
    assert errs["torch"] == errs["jax"] == (
        "1 download(s) failed; first: x__01:cobs: "
        "download failed after 1 attempts: http://127.0.0.1:1/none.xz"
    )
    assert not list((tmp_path / "torch").rglob("*.xz*"))


def test_retry_with_linear_backoff(server, tmp_path, monkeypatch):
    """Two failures, then the file: sleeps of wait*1 and wait*2 (the
    reference's download.sh), as the JAX package does."""
    base, hits, fail = server
    sleeps = {}
    for side, mod in MODS.items():
        got = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        fail[0] = 2
        out = mod.download_file(f"{base}/f.xz", tmp_path / side / "f.xz", retries=3, retry_wait=7)
        assert out.read_bytes() == PAYLOAD
        sleeps[side] = got
    assert sleeps["torch"] == sleeps["jax"] == [7, 14]
    fail[0] = 5
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        tdl.download_file(f"{base}/g.xz", tmp_path / "g.xz", retries=2, retry_wait=0)
    assert not (tmp_path / "g.xz").exists()


def test_check_xz_like_jax(tmp_path):
    small = tmp_path / "small.xz"
    small.write_bytes(lzma.compress(b"x"))
    junk = tmp_path / "junk.xz"
    junk.write_bytes(os.urandom(150_000))
    good = tmp_path / "good.xz"
    good.write_bytes(PAYLOAD)
    for mod in MODS.values():
        with pytest.raises(ValueError, match="too small"):
            mod.check_xz(small)
        with pytest.raises(ValueError, match="not a valid xz archive"):
            mod.check_xz(junk)
        mod.check_xz(good)


def test_download_subcommand_equals_jax(server, tmp_path, monkeypatch):
    base, hits, _ = server
    out = {}
    for side, (mod, main) in {"jax": (jdl, jax_main), "torch": (tdl, cli.main)}.items():
        _route(monkeypatch, mod, base)
        wd = tmp_path / side
        (wd / "data").mkdir(parents=True)
        (wd / "data" / "b.txt").write_text("one__01\ntwo__01\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["download", "--workdir", str(wd), "--batches", "data/b.txt", "--only", "cobs"])
        out[side] = buf.getvalue()
        assert sorted(p.name for p in (wd / "cobs").iterdir()) == [
            "one__01.cobs_classic.xz", "two__01.cobs_classic.xz"
        ]
    assert out["torch"] == out["jax"] == "one__01: downloaded (cobs)\ntwo__01: downloaded (cobs)\n"
    assert len(hits) == 4

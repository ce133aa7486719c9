"""The port's surface against the JAX package's: an AST diff of every
module's top-level functions and classes, and each class's methods. The
names the port lacks must be exactly the deliberate omissions below, each
with its reason; a function the JAX package gains, or one the port loses,
fails this test until it is ported or written down here."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

#: JAX names (module path inside the package, dotted) the port leaves out
OMITTED = {
    "ops.match.match_scores_pallas": "Pallas kernel B1: CUDA C++ in csrc/match_popcount.cu (match_scores_b1)",
    "ops.match.match_scores_pallas_v2": "Pallas kernel B2: the H = 1 instance of the same CUDA kernel",
    "ops.match._match_kernel_body": "body of the Pallas kernel B1, replaced with it",
    "ops.match._v2_kernel_body": "body of the Pallas kernel B2, replaced with it",
    "ops.match.match_scores_xla": "the XLA spelling; match_scores_ref is the plain torch version",
    "ops.match.match_scores_xla_dedup": "the XLA spelling of the dedup gather; match_scores_dedup",
    "models.matcher._rows_from_hashes_dev": "uint32 modulo steps; the port's split-int64 _rows_from_hashes",
    "align.engine._diag_cigar": "never called in the JAX package",
    "align.engine._soft_clip_ends": "never called in the JAX package",
    "ops.extend._reconstruct": "never called in the JAX package",
    "parallel.mesh.queries_sharding": "a jax.sharding construct; the port's Mesh cells place shards",
    "parallel.mesh.words_sharding": "a jax.sharding construct; the port's Mesh cells place shards",
    "parallel.dist.shard_map": "jax.shard_map; parallel.dist runs each cell's kernel in turn",
    "utils.jaxcache.enable": "XLA's compilation cache; the kernels' build directory keyed by source",
    "utils.platform.ensure_backend": "JAX backend selection; utils.platform.resolve_device",
}


def surface(pkg: str) -> set[str]:
    out = set()
    root = REPO / pkg
    for p in root.rglob("*.py"):
        parts = p.relative_to(root).with_suffix("").parts
        mod = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        for node in ast.parse(p.read_text(), str(p)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = f"{mod}.{node.name}" if mod else node.name
                out.add(name)
                if isinstance(node, ast.ClassDef):
                    out |= {
                        f"{name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    }
    return out


def test_port_lacks_only_the_written_omissions():
    missing = surface("phylign_tpu") - surface("phylign_tpu_torch")
    assert sorted(missing - OMITTED.keys()) == [], "JAX names the port lacks"
    assert sorted(OMITTED.keys() - missing) == [], "omissions the port now has, or JAX lost"
    assert all(reason.strip() for reason in OMITTED.values())


def test_surface_reads_methods_and_packages():
    jax = surface("phylign_tpu")
    for name in ("cli.cli_entry", "models.matcher.Matcher.rows_for_queries",
                 "native.native_xxh64", "pipeline.stages.QuerySet.raw_per_record"):
        assert name in jax and name in surface("phylign_tpu_torch")

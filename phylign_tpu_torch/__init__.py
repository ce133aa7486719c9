"""phylign-tpu on PyTorch and CUDA: the port of ``phylign_tpu`` to one
NVIDIA Hopper GPU.

Module names follow the JAX package, so each counterpart sits at the same
path. The port is self-contained: it keeps its own copies of the host code
it needs (FASTA/COBS IO, k-mer hashing, the native host library, match
postprocessing and filtering, the config, the manifest and scheduler, the
synthetic fixture) and imports nothing of ``phylign_tpu`` and nothing of
``jax``.

Ported so far: the ``match`` entry point (preprocess -> match -> filter).

- ``phylign_tpu_torch.ops.match``        gather + vertical popcount scoring:
                                         the plain PyTorch version and the
                                         hand-written CUDA kernels B1/B2.
- ``phylign_tpu_torch.models.matcher``   Matcher / ChunkedMatcher: hash ->
                                         row, scoring, threshold, top-k and
                                         hit compaction on the device.
- ``phylign_tpu_torch.pipeline.stages``  the match half of the pipeline.
- ``phylign_tpu_torch.cli``              ``python -m phylign_tpu_torch.cli
                                         match ...``.
- ``phylign_tpu_torch.convert``          state carried across from the JAX
                                         package (tests).
"""

from phylign_tpu_torch.version import __version__

__all__ = ["__version__"]

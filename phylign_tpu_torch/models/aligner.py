"""Aligner: the align stage's model step (the counterpart of
``phylign_tpu/models/aligner.py``).

Bundles the two device kernels of the seed-chain-extend path (ops.chain,
kernel B3, and ops.extend, kernel B4) as one step over fixed-shape pair
batches: the counterpart of models.matcher.Matcher for the align stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phylign_tpu_torch.ops.chain import ChainResult, chain_anchors
from phylign_tpu_torch.ops.extend import SrScoring, extend_banded_scores


class AlignStep(NamedTuple):
    chain: ChainResult
    align_score: torch.Tensor  # f32 [P]
    align_end_d: torch.Tensor  # int32 [P]


def align_step(
    rpos: torch.Tensor,  # int32 [P, A] padded anchors
    qpos: torch.Tensor,  # int32 [P, A]
    q_codes: torch.Tensor,  # uint8 [P, L]
    q_len: torch.Tensor,  # int32 [P]
    rwin: torch.Tensor,  # uint8 [P, L + band]
    rwin_valid: torch.Tensor,  # bool [P, L + band]
    k: int = 21,
    max_gap: int = 100,
    bandwidth: int = 100,
    scoring: SrScoring = SrScoring(),
) -> AlignStep:
    """One device step: chain all pairs, then banded-extend all pairs.

    The production engine (align.engine) runs the two kernels separately so
    the chain result can prune the extension batch; this combined form is
    the model-level forward."""
    chain = chain_anchors(rpos, qpos, k=k, max_gap=max_gap, bandwidth=bandwidth)
    score, end_d = extend_banded_scores(q_codes, q_len, rwin, rwin_valid, scoring=scoring)
    return AlignStep(chain=chain, align_score=score, align_end_d=end_d)

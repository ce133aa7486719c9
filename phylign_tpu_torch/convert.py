"""Carry match-stage state across from the JAX package.

The JAX ``Matcher`` and ``DeviceQueryHashes`` hold their arrays on a JAX
device; these functions read them as numpy (``np.asarray``) and build the
port's counterparts, so both packages score the same padded word matrix and
the same hashes. Nothing here imports jax: the objects come from the
caller. The path from an on-disk index is ``Matcher.from_device_index``.
"""

from __future__ import annotations

import numpy as np
import torch

from phylign_tpu_torch.models.matcher import DeviceQueryHashes, Matcher


def matcher_from_jax(m, device: str | torch.device = "cuda") -> Matcher:
    """The port's Matcher over the same [S+1, Wp] words (padding included)
    as the JAX ``phylign_tpu.models.matcher.Matcher`` ``m``."""
    words = np.ascontiguousarray(np.asarray(m.words, dtype=np.uint32))
    return Matcher(
        term_size=m.term_size,
        num_hashes=m.num_hashes,
        signature_size=m.signature_size,
        doc_names=list(m.doc_names),
        words=torch.from_numpy(words.view(np.int32).copy()).to(device),
        dedup=bool(m.dedup),
    )


def query_hashes_from_jax(
    dq, device: str | torch.device = "cuda"
) -> DeviceQueryHashes:
    """The port's DeviceQueryHashes for the JAX ``DeviceQueryHashes``
    ``dq``: the same u32 hash halves, held as int64 below 2**32."""
    dev = torch.device(device)

    def half(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(dev)

    return DeviceQueryHashes(
        hi=half(dq.hi),
        lo=half(dq.lo),
        n_kmers=np.asarray(dq.n_kmers, np.int32).copy(),
        raw=list(dq.raw),
        q_real=dq.q_real,
    )

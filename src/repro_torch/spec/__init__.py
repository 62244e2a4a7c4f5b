"""Speculative decoding over the paged-KV runtime (PyTorch port of
`repro.spec`).

drafter -> `DecoderLM.paged_verify_step` (the multi-query
`paged_flash_verify` kernel over the page pool) -> accept/reject
(target-distribution-preserving) -> multi-token append + rollback
(`PagedKVCache.trim`).
"""
from .decode import SpecConfig, SpecDecoder
from .drafter import Drafter, DraftModelDrafter, DraftProposal, NGramDrafter
from .verify import accept_draft

__all__ = ["SpecConfig", "SpecDecoder", "Drafter", "DraftModelDrafter",
           "DraftProposal", "NGramDrafter", "accept_draft"]

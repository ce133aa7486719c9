"""Align stage: batched seed-chain-extend over candidate (query, genome) pairs."""

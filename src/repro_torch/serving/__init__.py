"""Serving: execution plans over frozen packs, SLO policy, micro-batcher."""

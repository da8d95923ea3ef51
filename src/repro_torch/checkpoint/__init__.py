"""Checkpoints: the at-rest export of frozen serving packs."""

"""Histories: the op schema, row explosion, JSONL store, synthesis, packing."""

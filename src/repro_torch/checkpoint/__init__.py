"""Atomic + async checkpointing."""

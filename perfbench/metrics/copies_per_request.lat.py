"""Copies the hedged service dispatched per request in the window (its own counters; layer: service)."""
from perfbench import readers


def read(run):
    return readers.copies_per_request(run)

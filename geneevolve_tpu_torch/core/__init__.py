"""Segment-ledger engine: ledger math, phenotypes, the simulation loop."""

"""Telemetry: memory reports and stage timing."""

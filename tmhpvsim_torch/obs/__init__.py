"""Reduce-mode observers: numerics telemetry and fleet-risk analytics."""

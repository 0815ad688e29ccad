"""Serving: replica engines, the hedged (redundant-dispatch) scheduler,
the adaptive batched service with its controller and telemetry, trace
replay and fault injection."""

"""Serving: replica engines and the hedged (redundant-dispatch)
scheduler. The adaptive batched service, its controller, trace replay,
telemetry and fault injection are still to port (ROADMAP queue 1)."""

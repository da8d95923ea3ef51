"""Runtime: integrity checks and fault injection for serving."""

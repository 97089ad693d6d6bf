"""Model modules and the streaming engine."""

"""Host-side tracing spans and counters of the port."""

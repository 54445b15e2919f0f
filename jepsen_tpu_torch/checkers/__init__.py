"""Queue checkers: total-queue and per-value queue linearizability."""

"""Run indexing (the port's copy of what the service needs of it)."""

"""The port's benchmark: the harness, its traffic, references and metrics."""

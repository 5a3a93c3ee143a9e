"""Entry points of the port: ``serve`` (batched decode with the live vet
dashboard)."""

"""Entry points of the port: ``serve`` (batched decode with the live vet
dashboard) and ``train`` (the fault-tolerant training loop with its vet
report), and ``steps``, the train, prefill and decode step factories."""

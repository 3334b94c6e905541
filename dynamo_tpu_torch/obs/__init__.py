"""The port's observability: the compile ledger of captured step programs."""

"""Distribution: gradient compression (the sharding rules and pipeline
parallelism wait for the multi-device slice)."""

"""LLM-training workload generation: parallelism groups, collectives
decomposed into flows, and the Table-1 training programs as phase DAGs."""

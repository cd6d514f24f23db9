"""The benchmark's plain reference: frozen copies of the JAX package's
pure-Python fabric, traffic and packet-oracle modules (``src/repro/net``,
``src/repro/workload``), a NumPy fluid model written from its equations, and
the job a configuration file states.  Nothing here imports the program, JAX
or the JAX package."""

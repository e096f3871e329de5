"""Data parallelism: the process group and its collectives
(``parallel.mesh``)."""

"""Data parallelism: the process group and its collectives
(``parallel.mesh``), and ZeRO-1's sharded optimizer state
(``parallel.sharding``)."""

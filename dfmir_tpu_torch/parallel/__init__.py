"""Data parallelism over processes (the JAX package's ``parallel/``):
``mesh`` holds the rank's view of the process group and the collectives
of a step, ``launch`` starts one rank per device."""

"""The benchmark's own code: loading a cell from its files, weights and
traffic from the seed, the window's arithmetic, the profiler trace's
reduction, the result line.  It imports the program under test
(``repro_torch``) only in ``drivers/``, and never the JAX package."""

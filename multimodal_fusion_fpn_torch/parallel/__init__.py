"""Data parallelism of the port: the process mesh (:mod:`.mesh`), its
collectives (:mod:`.comm`) and the data-parallel train step (:mod:`.step`)."""

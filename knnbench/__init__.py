"""The benchmark of ``petal_neighbors_tpu_torch`` (see ``README.md``)."""

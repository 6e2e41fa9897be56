"""Distribution helpers: the logical-axis sharding context (``sharding``)."""

"""Memory planning for the co-resident engines (``budget``)."""
